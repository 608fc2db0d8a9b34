"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, the Stage-3 surfel training step
(`vidu4d_tpu_torch.engine.gs4d_trainer.Stage3Trainer.train_step`), at the
workload `bench.py` times: 200k surfels, 256x256, 2 frames per step, SH
degree 3, 25 bones, in the configuration
``--fg_motion gs-bob --nogs_optim_warp --rgb_loss_only --flow_wt 0``.
Weights are random from a seed; the data is the synthetic database of
`tests/helpers.make_fake_db`.

Phases (any failed check raises, so the exit code is non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from vidu4d_tpu_torch/csrc with nvcc (timed);
  3. hold each kernel against its plain PyTorch version on seeded scenes:
     64^2 and 256^2, 2 folded frames, 0 and 2 extra channels, a deep chain
     of 24k splats over one tile, and entry_cap below the entry count;
  4. one small step (64^2, 4k surfels) on the card vs the same step on the
     CPU (plain versions), from the same state and batch;
  5. build the main trainer, set the intrinsics to the pixel-true prior and
     place the cloud through the warp on one batch (as bench.py does; every
     step then trains on that batch, as bench.py's timed steps do); require
     >= 50% of the surfels valid in each frame;
  6. compare the kernels with their plain versions at the main path's
     shapes and time both (CUDA events, plain/kernel/kernel/plain);
  7. reset the launch counters, run 2 warm-up + 8 timed steps, read the
     counters: both kernels must have launched and no plain version run;
     loss and gnorm must be finite.
The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.

Tolerances (kernel vs plain version, same inputs, float32):
  forward: max |diff| <= 5e-4 on colour and the aux channels except the two
    discontinuous ones (median depth/weight, n_contrib), which must agree
    on >= 99.9% of pixels (an include or T > 0.5 decision can flip on one
    rounding); 5e-4 is the Pallas-vs-XLA bound of tests/test_pallas_kernel.py;
  backward: in each column c of the (E, 32) grad slab,
    max |diff_c| <= 1e-3 * max |g_c| + 1e-6 * max |g| (summation order
    differs: the kernel rebuilds T by sequential division and reduces
    across warps). The bound is per column because the PB/PC columns scale
    with pixel coordinates and are orders of magnitude above the opacity,
    colour, normal and extra columns; the floor covers columns whose
    per-pixel terms cancel in the sum.
Whole small step, card vs CPU: losses and gnorm to 1e-4 / 1e-3 relative,
surfel gradients to 5e-3 * max |g| (see STEP_GRAD_REL_TOL).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

MAIN_SURFELS, MAIN_RES = 200_000, 256  # the bench.py workload
FWD_TOL = 5e-4
DISCONT_AGREE = 0.999
BWD_REL_TOL = 1e-3
BWD_FLOOR = 1e-6
# whole step, CPU (plain versions) vs card (kernels): the depth loss divides
# by the rendered alpha, so pixels of small alpha scale rounding differences
# by depth / alpha^2, and the warp's reductions sum in another order
STEP_GRAD_REL_TOL = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_scene(rng, n, res, frames, n_extra, device, deep=False):
    """Seeded splat projections (M, P) + colours for the kernel checks.
    deep: every splat projects into the middle of one 16x16 tile, with low
    opacities, so per-pixel chains run for hundreds of entries."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize.common import project_splats

    shift = 0.0
    if deep:
        means = np.zeros((n, 3))
        means[:, :2] = rng.normal(0.0, 0.012, size=(n, 2))
        means[:, 2] = 2.0 + rng.uniform(0.0, 1.0, size=n)
        scales = np.full((n, 2), 0.01)
        opac = rng.uniform(0.005, 0.02, size=n)
        shift = 8.0  # principal point in the middle of a tile
    else:
        means = rng.normal(size=(n, 3)) * 0.6 + np.array([0.0, 0.0, 3.0])
        scales = np.exp(rng.normal(size=(n, 2)) * 0.5) * 0.04
        opac = 1.0 / (1.0 + np.exp(-rng.normal(size=n)))
    quats = rng.normal(size=(frames, n, 4))
    means_b = np.stack([means + f * np.array([0.05, -0.03, 0.1]) for f in range(frames)])
    colors = rng.uniform(size=(frames, n, 3 + n_extra))
    if n_extra:
        colors[..., 3:] = rng.normal(size=(frames, n, n_extra))
    intr = np.tile([res * 1.0, res * 1.0, res / 2.0 + shift, res / 2.0 + shift],
                   (frames, 1))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    proj = project_splats(t(means_b), t(quats), t(scales), torch.eye(4, device=device),
                          t(intr))
    bg = t(rng.uniform(size=3 + n_extra))
    return proj, t(colors), t(opac), bg


def compare_kernels(batch, rng, name, reps_k=20, reps_p=2, timed=False):
    """Run both kernels and both plain versions on one prepared batch;
    check the tolerances; return errors and (optionally) timings."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    geo = (batch["tiles_x"], batch["tiles_per_frame"], batch["n_extra"])
    fw_args = (batch["slab"], batch["tile_start"], batch["tile_count"], batch["bg"])
    col_k, aux_k = tf.forward_tiles(*fw_args, *geo)
    torch.cuda.synchronize()
    col_p, aux_p = tf.forward_tiles_plain(*fw_args, *geo)
    torch.cuda.synchronize()
    smooth = [i for i in range(12) if i not in (5, 7, 9)]
    fwd_err = max(float((col_k - col_p).abs().max()),
                  float((aux_k[..., smooth] - aux_p[..., smooth]).abs().max()))
    agree = {
        ch: float(((aux_k[..., i] - aux_p[..., i]).abs() <= FWD_TOL).float().mean())
        for ch, i in (("median_depth", 5), ("median_weight", 7), ("n_contrib", 9))
    }
    if not fwd_err <= FWD_TOL or min(agree.values()) < DISCONT_AGREE:
        per_ch = [float(x) for x in (col_k - col_p).abs().amax(dim=(0, 1))] + \
            [float(x) for x in (aux_k - aux_p).abs().amax(dim=(0, 1))]
        raise AssertionError(f"[{name}] forward kernel disagrees with its plain "
                             f"version: max_abs_err={fwd_err}, agree={agree}, "
                             f"per channel (color, aux)={per_ch}")

    nt = batch["tile_start"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    cot = torch.randn((nt, 256, 10 + batch["n_extra"]), device="cuda", generator=gen)
    resid = aux_k[..., 8:12].contiguous()
    bw_args = (batch["slab"], batch["tile_start"], batch["tile_count"], cot, resid)
    g_k = tb.backward_tiles(*bw_args, *geo)
    torch.cuda.synchronize()
    g_p = tb.backward_tiles_plain(*bw_args, *geo)
    torch.cuda.synchronize()
    col_err = (g_k - g_p).abs().amax(dim=0)
    col_max = g_p.abs().amax(dim=0)
    bwd_err, g_max = float(col_err.max()), float(col_max.max())
    bad = torch.nonzero(col_err > BWD_REL_TOL * col_max + BWD_FLOOR * g_max).flatten()
    if bad.numel():
        raise AssertionError(
            f"[{name}] backward kernel disagrees with its plain version in slab "
            f"columns {bad.tolist()}: max_abs_err {col_err[bad].tolist()}, "
            f"max|g| {col_max[bad].tolist()}")
    # the largest per-column error relative to that column's bound
    bwd_bound_share = float((col_err / (BWD_REL_TOL * col_max + BWD_FLOOR * g_max
                                        + 1e-30)).max())
    res = {"case": name, "fwd_max_abs_err": fwd_err, "fwd_discont_agree": agree,
           "bwd_max_abs_err": bwd_err, "bwd_max_abs_g": g_max,
           "bwd_bound_share": bwd_bound_share,
           "entries": int(batch["tile_count"].sum()),
           "max_tile": int(batch["tile_count"].max())}
    if timed:
        # plain, kernel, kernel, plain: compare within one run, in turns
        fk = lambda: tf.forward_tiles(*fw_args, *geo)
        fp = lambda: tf.forward_tiles_plain(*fw_args, *geo)
        bk = lambda: tb.backward_tiles(*bw_args, *geo)
        bp = lambda: tb.backward_tiles_plain(*bw_args, *geo)
        fk(), bk()
        pf = [cuda_ms(fp, reps_p)]
        pb = [cuda_ms(bp, reps_p)]
        kf = [cuda_ms(fk, reps_k), cuda_ms(fk, reps_k)]
        kb = [cuda_ms(bk, reps_k), cuda_ms(bk, reps_k)]
        pf.append(cuda_ms(fp, reps_p))
        pb.append(cuda_ms(bp, reps_p))
        res.update(fwd_ms=float(np.mean(kf)), fwd_plain_ms=float(np.mean(pf)),
                   bwd_ms=float(np.mean(kb)), bwd_plain_ms=float(np.mean(pb)))
    log(f"[check] {json.dumps(res)}")
    return res


def kernel_cases(rng):
    import torch

    from vidu4d_tpu_torch.ops.rasterize.tile_backward import prepare_batch

    cases = [
        ("64x64 2 frames X=0", dict(n=3000, res=64, frames=2, n_extra=0), 0),
        ("256x256 2 frames X=2", dict(n=40000, res=256, frames=2, n_extra=2), 0),
        ("deep chain 24k splats / one tile", dict(n=24000, res=64, frames=1,
                                                 n_extra=0, deep=True), 0),
        ("256x256 entry_cap < entries", dict(n=40000, res=256, frames=2,
                                             n_extra=0), 40000),
    ]
    for name, kw, cap in cases:
        with torch.no_grad():
            proj, colors, opac, bg = random_scene(rng, device="cuda", **kw)
            batch = prepare_batch(proj, colors, opac, bg, kw["res"], kw["res"],
                                  span_cap=4, entry_cap=cap)
        if cap:
            full = prepare_batch(proj, colors, opac, bg, kw["res"], kw["res"],
                                 span_cap=4, entry_cap=0)
            n_full, n_cap = int(full["tile_count"].sum()), int(batch["tile_count"].sum())
            if not n_cap < n_full:
                raise AssertionError(f"[{name}] entry_cap did not truncate "
                                     f"({n_cap} of {n_full})")
            log(f"[check] {name}: {n_cap} of {n_full} entries kept")
        compare_kernels(batch, rng, name)


def calibrate_scene(trainer, pts, batch):
    """bench.py:_calibrate_scene through the port's warp: affine-fit
    cam = world @ A + b on a subsample, solve for a cloud that lands in a
    visible camera-space box; iterate to absorb the warp's nonlinearity."""
    import torch

    d = trainer.deformer
    dev = trainer.device
    n = pts.shape[0]
    with torch.no_grad():
        samples = d.get_samples(batch)
        rot = torch.zeros((n, 4), device=dev)
        rot[:, 0] = 1.0
        rngl = np.random.default_rng(1)
        target = (rngl.normal(size=(n, 3)) * np.array([0.05, 0.06, 0.035])
                  + np.array([0.0, 0.0, 0.38])).astype(np.float32)
        sub = np.arange(0, n, max(1, n // 2048))
        for _ in range(3):
            xc = d.warp_surfels(torch.as_tensor(pts, device=dev), rot, samples)[0]
            xc = xc.cpu().numpy()
            x_s = np.concatenate([pts[sub]] * xc.shape[0])
            y_s = np.concatenate([xc[f][sub] for f in range(xc.shape[0])])
            xh = np.concatenate([x_s, np.ones((len(x_s), 1), np.float32)], 1)
            w, *_ = np.linalg.lstsq(xh, y_s, rcond=None)
            pts = ((target - w[3]) @ np.linalg.pinv(w[:3], rcond=1e-3)).astype(np.float32)
    return pts


def scene_diag(prepared):
    """Per-frame valid surfels / entries the kernels see / occupied tiles /
    densest tile, from the kernels' inputs of one step."""
    counts = prepared["tile_count"].reshape(-1, prepared["tiles_per_frame"])
    return {"valid": prepared["valid"].tolist(),
            "entries": counts.sum(dim=1).tolist(),
            "tiles_occupied": (counts > 0).sum(dim=1).tolist(),
            "max_tile": counts.amax(dim=1).tolist()}


def load_make_fake_db():
    """tests/helpers.make_fake_db, loaded by path: an installed package
    named ``tests`` would shadow the repo's (a directory without
    __init__.py)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "helpers.py")
    spec = importlib.util.spec_from_file_location("vidu4d_test_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_fake_db


def build_trainer(tmp, device, surfels, res, frames=2):
    import torch

    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu_torch.models.gaussian.surfels import init_from_points

    db = load_make_fake_db()(tmp, num_vids=1, T=16, H=res, W=res)
    opts = {
        "dataroot": db, "seqname": "toy", "logname": "smoke",
        "logroot": os.path.join(tmp, "logdir"), "data_prefix": "crop",
        "train_res": res, "pixels_per_image": -1, "imgs_per_gpu": frames // 2,
        "fg_motion": "gs-bob", "gs_capacity": surfels, "gs_init_samples": surfels,
        "sh_degree": 3, "raster_impl": "pallas_grad", "raster_span_cap": 4,
        "num_rounds": 60, "iters_per_round": 200,
        "gs_optim_warp": False, "rgb_loss_only": True, "flow_wt": 0.0,
    }
    trainer = Stage3Trainer(opts, device)
    n_frames = int(np.asarray(trainer.frame_info.frame_offset)[-1])
    prior = np.tile(np.array([1.2 * res, 1.2 * res, res / 2, res / 2], np.float32),
                    (n_frames, 1))
    init_intrinsics_base_params(trainer.deformer.intrinsics, prior, trainer.frame_info)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(surfels, 3)).astype(np.float32)
    pts *= np.array([0.03, 0.04, 0.03], np.float32)
    batch = trainer._next_batch()
    pts = calibrate_scene(trainer, pts, batch)
    cols = rng.uniform(size=(surfels, 3)).astype(np.float32)
    feats = rng.normal(size=(surfels, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    t = lambda a: torch.as_tensor(a, device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    trainer.set_surfels(init_from_points(t(pts), t(cols), surfels, sh_degree=3,
                                         generator=gen, regist_feat=t(feats)))
    return trainer, batch


def small_step_vs_cpu(tmp):
    """One step at 64^2 / 4k surfels on the card (kernels) and on the CPU
    (plain versions) from the same state and batch: the port's own
    reference on a small input."""
    import torch

    from vidu4d_tpu_torch.models.gaussian.surfels import SurfelState, SurfelParams
    from vidu4d_tpu_torch.models.gaussian.optimizer import gs_adam_init

    cpu, batch = build_trainer(os.path.join(tmp, "small_cpu"), "cpu", 4096, 64)
    gpu, _ = build_trainer(os.path.join(tmp, "small_gpu"), "cuda", 4096, 64)
    gpu.deformer.load_state_dict(cpu.deformer.state_dict())
    s = cpu.surfels
    gpu.surfels = SurfelState(
        params=SurfelParams(*[p.detach().clone().cuda().requires_grad_(True)
                              for p in s.params]),
        alive=s.alive.cuda(), max_radii2d=s.max_radii2d.cuda(),
        grad_accum=s.grad_accum.cuda(), denom=s.denom.cuda())
    gpu.gs_adam = gs_adam_init(gpu.surfels.params)
    m_cpu = cpu.train_step(batch)
    m_gpu = gpu.train_step({k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    out = {}
    for k, tol in (("total", 1e-4), ("rgb", 1e-4), ("mask", 1e-4), ("depth", 1e-3),
                   ("gnorm", 1e-3)):
        a, b = float(m_cpu[k]), float(m_gpu[k])
        rel = abs(a - b) / max(abs(a), 1e-12)
        out[k] = {"cpu": a, "gpu": b, "rel": rel}
        if not rel <= tol:
            raise AssertionError(f"small step: {k} cpu={a} gpu={b} rel={rel} > {tol}")
    # surfel gradients (kept on the leaves after the step): the first Adam
    # step moves every param by ~lr * sign(g), so compare g itself
    bad = []
    for f in ("xyz", "opacity", "features_dc", "scaling", "rotation"):
        gc = getattr(cpu.surfels.params, f).grad
        gg = getattr(gpu.surfels.params, f).grad.cpu()
        err, gmax = float((gc - gg).abs().max()), float(gc.abs().max())
        out[f"grad_{f}"] = {"max_abs_err": err, "max_abs_g": gmax}
        if not err <= STEP_GRAD_REL_TOL * gmax:
            bad.append(f)
    log(f"[small step cpu-vs-gpu] {json.dumps(out)}")
    if bad:
        raise AssertionError(f"small step: gradients of {bad} differ beyond "
                             f"{STEP_GRAD_REL_TOL} * max|g|")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs "
                         "only on a machine with an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vidu4d_tpu_torch import kernels

    # float32 matmuls in full precision (the default), stated explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_name_and_power()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    info = kernels.build()
    log(f"[build] {info['path']} in {info['seconds']:.1f} s (cached={info['cached']})")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    kernels.library()

    rng = np.random.default_rng(1234)
    kernel_cases(rng)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        small_step_vs_cpu(tmp)

        t0 = time.perf_counter()
        trainer, batch = build_trainer(os.path.join(tmp, "main"), "cuda", MAIN_SURFELS,
                                       MAIN_RES)
        torch.cuda.synchronize()
        log(f"[setup] trainer + calibrated scene in {time.perf_counter() - t0:.1f} s")
        # the kernels' inputs of the main path's first step
        with torch.no_grad():
            main_batch, _ = trainer.render_inputs(batch)
        diag = scene_diag(main_batch)
        log(f"[scene] {json.dumps(diag)} entry_cap {trainer.raster_cfg.entry_cap}")
        if min(diag["valid"]) < 0.5 * MAIN_SURFELS:
            raise AssertionError(f"degenerate scene, < 50% surfels valid: {diag}")

        # the kernels at the main path's shapes: check and time
        main_cmp = compare_kernels(main_batch, rng, "main path 200k 256x256 2 frames",
                                   timed=True)
        del main_batch

        # the main path: counters from 0, warm-up + timed steps
        kernels.reset_counts()
        step_ms, metrics = [], None
        for i in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            if i >= 2:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(kernels.COUNTS)
        m = {k: float(v) for k, v in metrics.items()}
        log(f"[steps] metrics of the last step {json.dumps(m)}")
        log(f"[steps] step_ms {json.dumps([round(x, 3) for x in step_ms])} "
            f"median {float(np.median(step_ms)):.3f} ms "
            f"peak_mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[counts] {json.dumps(counts)}")
        if not (np.isfinite(m["total"]) and np.isfinite(m["gnorm"])):
            raise AssertionError(f"non-finite loss or gnorm: {m}")
        if counts["tile_forward"] < 1 or counts["tile_backward"] < 1:
            raise AssertionError(f"a kernel of the path never launched: {counts}")
        if counts["tile_forward_plain"] or counts["tile_backward_plain"]:
            raise AssertionError(f"a plain version ran on the main path: {counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    result = {"kernels": [
        {"name": "tile_forward", "route": "cuda",
         "source": "vidu4d_tpu_torch/csrc/tile_forward.cu",
         "replaces": "vidu4d_tpu/ops/rasterize/pallas_kernel.py:111",
         "launches": counts["tile_forward"],
         "max_abs_err": main_cmp["fwd_max_abs_err"],
         "ms": main_cmp["fwd_ms"], "plain_ms": main_cmp["fwd_plain_ms"]},
        {"name": "tile_backward", "route": "cuda",
         "source": "vidu4d_tpu_torch/csrc/tile_backward.cu",
         "replaces": "vidu4d_tpu/ops/rasterize/pallas_backward.py:95",
         "launches": counts["tile_backward"],
         "max_abs_err": main_cmp["bwd_max_abs_err"],
         "ms": main_cmp["bwd_ms"], "plain_ms": main_cmp["bwd_plain_ms"]},
    ]}
    log(f"[summary] {card}: median step {float(np.median(step_ms)):.3f} ms; "
        f"tile_forward {main_cmp['fwd_ms']:.3f} ms (plain {main_cmp['fwd_plain_ms']:.3f}); "
        f"tile_backward {main_cmp['bwd_ms']:.3f} ms (plain {main_cmp['bwd_plain_ms']:.3f})")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
