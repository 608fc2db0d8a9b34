"""The benchmark of the PyTorch and CUDA port (``vidu4d_tpu_torch``): its
harness, configurations, traffic, metric readers, frozen plain reference
and tests. Nothing here imports JAX or the JAX package."""
