"""The yardstick's arithmetic: the H100's peaks, the tile kernels' work and
roofline bounds, and the step's FLOPs.

`needed_pairs` and `kernel_bounds` with ``OPS_RESPONSE``, ``PEAK_FP32`` and
``PEAK_BYTES`` are frozen from ``chip_smoke.py`` at commit 1fb37daff6a2;
the (entry, pixel) pairs come from the frozen plain compositor
(`portbench.kernel_work`) on the kernels' inputs, never from what the
program outputs.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from portbench import kernel_work as tf

# FP32 operations per (entry, pixel) pair, counted from the kernels' source
# (a division or an expf counts as one): the splat response and cull of
# every pair that needs it (the splat-centred rho2d, FIS (dx^2 + dy^2), is 6
# of them); the compositing of an included pair is 29 + 2 X more (forward),
# its gradient chain and column sums 105 + 4 X (backward)
OPS_RESPONSE = 34
# H100 SXM, FP32 outside the tensor cores (data sheet; an FMA counts as two
# operations). The port never enables TF32, so this is its matmuls' peak too.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


@torch.no_grad()
def plain_aux(batch: Dict) -> torch.Tensor:
    """The frozen plain forward's aux (T, tile^2, 12) on kernel inputs."""
    _, aux = tf.forward_tiles_plain(batch["slab"], batch["tile_start"], batch["tile_count"],
                                    batch["bg"], batch["tiles_x"], batch["tiles_per_frame"],
                                    batch["n_extra"], batch["tile"])
    return aux


@torch.no_grad()
def needed_pairs(batch: Dict, aux: torch.Tensor) -> Dict[str, int]:
    """(entry, pixel) pairs these inputs need, from the plain version's
    aux: the forward visits each pixel's entries up to its stop (the first
    candidate at or after its n_contrib, else the tile's end), and
    composites the candidates below n_contrib (included); the backward
    needs the response of each pixel's entries below its n_contrib
    (bwd_responses) and differentiates the included pairs. bwd_walked is
    what the backward kernel walks: every tile's entries below count_eff,
    its largest n_contrib, for all of the tile's pixels."""
    slab, start, count = batch["slab"], batch["tile_start"], batch["tile_count"]
    nt = start.shape[0]
    ncon = aux[..., 9]
    pxf, pyf = tf._pixel_centers(nt, batch["tiles_x"], batch["tiles_per_frame"],
                                 slab.device, batch["tile"])
    stop = torch.full_like(ncon, -1.0)
    included = 0
    k = torch.arange(tf.CHUNK, device=slab.device)
    for base in range(0, int(count.max()), tf.CHUNK):
        rank = base + k
        valid = rank[None, :] < count[:, None]
        idx = torch.clamp(start[:, None].long() + rank[None, :], max=slab.shape[0] - 1)
        r = tf.splat_response(slab[idx], pxf[:, None, :], pyf[:, None, :])
        alpha = torch.clamp(r["alpha_raw"], max=tf.ALPHA_CLAMP)
        cand = (r["pz_ok"] & (r["depth"] >= tf.NEAR_PLANE)
                & (alpha >= tf.ALPHA_EPS) & valid[..., None])
        below = rank.float()[None, :, None] < ncon[:, None, :]
        included += int((cand & below).sum())
        after = (cand & ~below).int()
        first = torch.where(after.any(1), base + after.argmax(1).float(), -1.0)
        stop = torch.where((stop < 0) & (first >= 0), first, stop)
    visited = torch.where(stop >= 0, stop + 1, count[:, None].float())
    count_eff = tf.effective_counts(count, aux[..., 8:12])
    return {"fwd_visited": int(visited.sum()), "included": included,
            "bwd_responses": int(ncon.double().sum()),
            "bwd_walked": int(count_eff.sum()) * batch["tile"] ** 2,
            "count_eff_entries": int(count_eff.sum())}


def kernel_bounds(batch: Dict, pairs: Dict[str, int]) -> Dict[str, Dict]:
    """The least time the card could take for each kernel's work on these
    inputs: the larger of its FP32 operations over 67 TFLOP/s and its bytes
    (inputs read once, outputs written once) over 3.35 TB/s."""
    x = batch["n_extra"]
    nt = batch["tile_start"].shape[0]
    px_n = batch["tile"] ** 2
    fwd_ops = OPS_RESPONSE * pairs["fwd_visited"] + (29 + 2 * x) * pairs["included"]
    bwd_ops = OPS_RESPONSE * pairs["bwd_responses"] + (105 + 4 * x) * pairs["included"]
    row = 32 * 4
    fwd_bytes = (int(batch["tile_count"].sum()) * row + nt * 8 + (3 + x) * 4
                 + nt * px_n * (3 + x + 12) * 4)
    # slab rows below count_eff read, their grad rows written (the rest of
    # the grad slab is zero-filled by torch, outside the kernel)
    bwd_bytes = (2 * pairs["count_eff_entries"] * row + nt * 8
                 + nt * px_n * (10 + x + 4) * 4)
    out = {}
    for name, ops, nbytes in (("tile_forward", fwd_ops, fwd_bytes),
                              ("tile_backward", bwd_ops, bwd_bytes)):
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def bounds_of(batch: Dict) -> Dict[str, Dict]:
    """`kernel_bounds` of one call's inputs, its pairs counted by the
    frozen plain compositor."""
    return kernel_bounds(batch, needed_pairs(batch, plain_aux(batch)))


MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::conv2d")
EXCLUDED = "portbench.excluded"


class MatmulFlops:
    """FLOPs of the matrix products (mm, addmm, bmm, baddbmm, conv2d: 2 per
    multiply-add) that run inside ``with``, on every thread (the backward
    runs on autograd's), from `torch.profiler`'s FLOP estimates, less those
    inside the functions given to `exclude` (the plain compositor, whose
    work `kernel_bounds` counts instead)."""

    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], with_flops=True)

    @staticmethod
    def exclude(fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(EXCLUDED):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    @property
    def flops(self) -> int:
        def excluded(e):
            while e is not None:
                if e.name == EXCLUDED:
                    return True
                e = e.cpu_parent
            return False
        return int(sum(e.flops or 0 for e in self.prof.events()
                       if e.name in MATMUL_OPS and not excluded(e)))
