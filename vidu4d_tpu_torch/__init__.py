"""vidu4d_tpu_torch: the PyTorch + CUDA port of vidu4d_tpu.

The JAX package (``vidu4d_tpu``) is the reference; this package mirrors its
module layout (``ops/``, ``ops/rasterize/``, ``models/fields/``,
``models/gaussian/``, ``engine/``, ``data/``, ``utils/``) and never imports
``jax``. The two TPU
Pallas rasterizer kernels are replaced by hand-written CUDA kernels for
Hopper (``csrc/``), each with a plain PyTorch version beside it that tensors
on the CPU run through.

It imports nothing of the JAX package: the numpy data path it needs
(``data/frame_info.py``, ``vidloader.py``, ``data_utils.py``) is its own
copy, restricted to the full-image reads the port trains on.
"""

__version__ = "0.1.0"
