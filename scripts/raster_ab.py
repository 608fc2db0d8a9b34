"""One checkout's rasterizer numbers on one CUDA GPU, for comparing two
commits inside one call: run it in each checkout in turns (parent,
change, change, parent).

    cd <checkout> && python3 <repo>/scripts/raster_ab.py LABEL [--c1] [--static] [--checks] [--fmad]

It imports `chip_smoke.py` and `vidu4d_tpu_torch` from the working
directory, so it measures that checkout. Always: the card, ptxas's
registers and spills, K1 / K2 ms (3 x 20 launches each, CUDA events) on
the main path's inputs (`chip_smoke.build_trainer`'s 200k-surfel 256^2
workload, X=2, its first step; random cotangents). --c1: chip_smoke's
`[c1]` gate at `C1_RUNS` from a fresh rng (1234). --static: chip_smoke's
static path (1237 x 822, 300 steps): initial and eval PSNR, median step
ms, its kernel check. --checks: each kernel
against its plain version on the main path's inputs and on
`tests/test_torch_c1.py`'s far-corner scene at tiles 8, 16 and 32 (the
errors, or the check's failure). --fmad: the kernels built without
`-fmad=false` (with nvcc's FMA contraction). Prints one line "AB {json}".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from vidu4d_tpu_torch import kernels  # noqa: E402
from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb  # noqa: E402
from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf  # noqa: E402


def check(b, name):
    """Both kernels against their plain versions on a prepared batch."""
    geo = (b["tiles_x"], b["tiles_per_frame"], b["n_extra"], b["tile"])
    fw = (b["slab"], b["tile_start"], b["tile_count"], b["bg"])
    got, ref = tf.forward_tiles(*fw, *geo), tf.forward_tiles_plain(*fw, *geo)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cot = torch.randn((b["tile_start"].shape[0], b["tile"] ** 2, 10 + b["n_extra"]),
                      device="cuda", generator=gen)
    bw = (b["slab"], b["tile_start"], b["tile_count"], cot, got[1][..., 8:12].contiguous())
    out = {}
    for key, fn in (("fwd", lambda: cs.check_forward(ref, got, name)),
                    ("bwd", lambda: cs.check_backward(tb.backward_tiles_plain(*bw, *geo),
                                                      tb.backward_tiles(*bw, *geo), name))):
        try:
            out[key] = fn()
        except AssertionError as e:
            out[key] = "FAIL " + str(e)[:400]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label")
    for flag in ("--c1", "--static", "--checks", "--fmad"):
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("raster_ab: needs a CUDA GPU")
    if args.fmad:
        kernels.NVCC_FLAGS = [f for f in kernels.NVCC_FLAGS if f != "-fmad=false"]
    out = {"label": args.label, "card": cs.gpu_name_and_power(),
           "nvcc_flags": " ".join(kernels.NVCC_FLAGS)}
    info = kernels.build()
    tf.tile_library()
    out["ptxas"] = [line.split(":", 1)[-1].strip() for line in info["ptxas"].splitlines()
                    if "registers" in line or "spill" in line]
    tmp = tempfile.mkdtemp()
    trainer, batch = cs.build_trainer(os.path.join(tmp, "main"), "cuda", cs.MAIN_SURFELS,
                                      cs.MAIN_RES)
    with torch.no_grad():
        mb, _ = trainer.render_inputs(batch)
        geo = (mb["tiles_x"], mb["tiles_per_frame"], mb["n_extra"], mb["tile"])
        fw = (mb["slab"], mb["tile_start"], mb["tile_count"], mb["bg"])
        _, aux = tf.forward_tiles(*fw, *geo)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cot = torch.randn((mb["tile_start"].shape[0], mb["tile"] ** 2, 10 + mb["n_extra"]),
                          device="cuda", generator=gen)
        bw = (mb["slab"], mb["tile_start"], mb["tile_count"], cot, aux[..., 8:12].contiguous())
        fk = lambda: tf.forward_tiles(*fw, *geo)
        bk = lambda: tb.backward_tiles(*bw, *geo)
        fk(), bk()
        out["k1_ms"] = [cs.cuda_ms(fk, 20) for _ in range(3)]
        out["k2_ms"] = [cs.cuda_ms(bk, 20) for _ in range(3)]
        out["entries"] = int(mb["tile_count"].sum())
        if args.checks:
            far_corner = cs.load_test_module("test_torch_tile_split")._far_corner
            out["checks"] = {"main path": check(mb, "main path")}
            for tile in tf.TILE_SIDES:
                name = f"far corner tile {tile}"
                out["checks"][name] = check(far_corner("cuda", tile), name)
    del trainer, batch, mb, aux, cot, bw, fw
    torch.cuda.empty_cache()
    if args.c1:
        try:
            out["c1"] = [cs.c1_gate(np.random.default_rng(1234), w, h, n)
                         for w, h, n in cs.C1_RUNS]
        except AssertionError as e:
            out["c1"] = "FAIL " + str(e)[:2000]
    if args.static:
        t0 = time.perf_counter()
        rep, _, cmp = cs.static_path(tmp, np.random.default_rng(1234))
        out["static"] = {k: rep[k] for k in ("init_psnr", "eval_psnr", "step_ms_median")}
        out["static_check"] = {k: cmp[k] for k in ("fwd_max_abs_err", "bwd_bound_share",
                                                   "fwd_ms", "bwd_ms")}
        out["static_s"] = time.perf_counter() - t0
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
