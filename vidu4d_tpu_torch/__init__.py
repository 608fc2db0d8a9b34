"""vidu4d_tpu_torch: the PyTorch + CUDA port of vidu4d_tpu.

The JAX package (``vidu4d_tpu``) is the reference; this package mirrors its
module layout (``ops/``, ``ops/rasterize/``, ``models/fields/``,
``models/gaussian/``, ``engine/``) and never imports ``jax``. The two TPU
Pallas rasterizer kernels are replaced by hand-written CUDA kernels for
Hopper (``csrc/``), each with a plain PyTorch version beside it that tensors
on the CPU run through.

The only code shared with the JAX package is its numpy-only data path
(``vidu4d_tpu.data.frame_info``, ``data_utils`` and ``vidloader``).
"""

__version__ = "0.1.0"
