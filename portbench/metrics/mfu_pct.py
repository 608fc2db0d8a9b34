"""mfu_pct: the whole step's share of the card's FP32 peak, in %: the
step's FLOPs counted by the benchmark (the matrix products of the plain
reference's first step, from `torch.profiler`'s FLOP estimates, its plain
compositor left out, plus the tile kernels' operations of the sampled
calls) over the traced run's step_ms and 67
TFLOP/s (the port never enables TF32)."""

from portbench.bounds import PEAK_FP32


def read(ctx):
    return 100.0 * ctx["flops_per_step"] / (ctx["step_ms"] / 1e3) / PEAK_FP32
