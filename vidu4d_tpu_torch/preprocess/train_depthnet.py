"""Train the monodepth U-Net on scenes rendered by the port's own rasterizer
(`scripts/train_depthnet.py`).

Scenes are random textured, Lambert-shaded shapes (spheres, ellipsoids,
tori, boxes) at depths 0.5-4 over a tilted textured back wall, usually a
ground plane and sometimes a side wall, rendered by
`ops.rasterize.api.rasterize` (the tile kernels on the card; one frame,
forward only); the ground truth depth is the alpha-normalised expected
depth, holes take the wall's. The loss is the scale-shift-invariant MAE +
multi-scale gradient matching (`depthnet.depth_loss`) + the pairwise
ordinal hinge (`depthnet.ranking_loss`). The held-out SSI-MAE and depth
order accuracy are compared with the flow-parallax fallback
(`depth.depth_from_flow_parallax`).

    python -m vidu4d_tpu_torch.preprocess.train_depthnet --steps 3000 \\
        [--out weights_out/depthnet_synthetic.npz] [--device cpu]

The flags and defaults are the JAX script's, except ``--out`` (under
``weights_out/``, never over the shipped file; ``$VIDU4D_DEPTHNET_NPZ``
selects another one) and ``--device`` (the card unless "cpu"). The scenes
come from ``np.random.default_rng(0)`` as the JAX script draws them. The
JAX script renders with ``RasterizeConfig(budget=1024)`` (the tiles path
drops a tile's entries past 1024), the port with the kernels' exact path:
the two agree while no tile holds more. Every JAX scene has the same
surfel rotations (`init_from_points`' default ``PRNGKey(0)``); the port
draws one set (`scene_rotations`) and uses it for every scene too.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch.ops import sh as sh_ops
from vidu4d_tpu_torch.ops.rasterize.api import rasterize
from vidu4d_tpu_torch.preprocess import train_common as tc
from vidu4d_tpu_torch.preprocess.depth import depth_from_flow_parallax
from vidu4d_tpu_torch.preprocess.depthnet import (
    DepthNet,
    depth_loss,
    load_depthnet,
    ranking_loss,
    ranking_pairs,
    save_weights,
    ssi_mae,
)
from vidu4d_tpu_torch.preprocess.ops import resize_hwc

# surfel slots of a scene: 9 blobs x 240 + the wall / floor / side-wall planes
SCENE_CAP = 3584


def _texture(rng: np.random.Generator, res: int, scales=(4, 8, 16, 32)) -> np.ndarray:
    """(res, res, 3) texture in [0, 1]: resized noise octaves weighted
    1 / sqrt(scale) (``jax.image.resize`` semantics: antialiased when an
    octave is finer than res)."""
    img = np.zeros((res, res, 3), np.float32)
    for s in scales:
        noise = rng.normal(size=(s, s, 3)).astype(np.float32)
        img += resize_hwc(torch.from_numpy(noise), (res, res)).numpy() / np.sqrt(s)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def _shape_points(rng: np.random.Generator, n: int):
    """(n, 3) surface points and outward normals of a random shape (sphere,
    ellipsoid, torus or box surface) under a random rotation."""
    kind = rng.integers(0, 4)
    if kind == 0:
        p = rng.normal(size=(n, 3))
        p /= np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-6)
        nrm = p.copy()
    elif kind == 1:
        axes = rng.uniform(0.35, 1.0, size=(3,))
        p = rng.normal(size=(n, 3))
        p /= np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-6)
        nrm = p / axes
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-6)
        p = p * axes
    elif kind == 2:
        th = rng.uniform(0, 2 * np.pi, size=n)
        ph = rng.uniform(0, 2 * np.pi, size=n)
        rt = 0.35
        p = np.stack([(1 + rt * np.cos(ph)) * np.cos(th), (1 + rt * np.cos(ph)) * np.sin(th),
                      rt * np.sin(ph)], -1) / (1 + rt)
        nrm = np.stack([np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th), np.sin(ph)], -1)
    else:
        face = rng.integers(0, 6, size=n)
        uv = rng.uniform(-1, 1, size=(n, 2))
        p = np.zeros((n, 3))
        nrm = np.zeros((n, 3))
        ax, sign = face % 3, np.where(face < 3, 1.0, -1.0)
        for a in range(3):
            m = ax == a
            others = [b for b in range(3) if b != a]
            p[m, a] = sign[m]
            p[m, others[0]] = uv[m, 0]
            p[m, others[1]] = uv[m, 1]
            nrm[m, a] = sign[m]
        p *= 0.7
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return (p @ rot.T).astype(np.float32), (nrm @ rot.T).astype(np.float32)


class SceneSplats(NamedTuple):
    """One scene's surfels, padded to SCENE_CAP slots (numpy)."""

    xyz: np.ndarray  # (cap, 3)
    colors: np.ndarray  # (cap, 3) shaded RGB
    scales_log: np.ndarray  # (cap,) log of both tangent scales
    n: int  # real surfels (the rest are padding)
    intrins: np.ndarray  # (4,) fx, fy, cx, cy
    wall_depth: float


def scene_splats(rng: np.random.Generator, res: int, n_blobs: Optional[int] = None
                 ) -> SceneSplats:
    """The surfels of one random scene, drawn from ``rng`` as the JAX
    ``make_scene`` draws them (`train_depthnet.py:107`)."""
    light = rng.normal(size=3)
    light /= np.linalg.norm(light)
    light[2] = -abs(light[2])
    ambient = rng.uniform(0.2, 0.6)
    n_blobs = n_blobs or rng.integers(1, 10)
    pts, cols, scales_log = [], [], []
    for _ in range(n_blobs):
        n = int(rng.integers(80, 240))
        ctr = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.4, 0.4),
                        rng.uniform(0.5, 4.0)], np.float32)
        rad = rng.uniform(0.04, 0.3)
        p, nrm = _shape_points(rng, n)
        p = ctr + p * rad * rng.uniform(0.85, 1.0, size=(n, 1))
        if rng.uniform() < 0.5:
            base = _texture(rng, 16)[rng.integers(0, 16, size=n), rng.integers(0, 16, size=n)]
        else:
            base = rng.uniform(0.1, 1.0, size=(1, 3))
        c = np.clip(base + rng.normal(0, 0.15, size=(n, 3)), 0, 1)
        lam = ambient + (1 - ambient) * np.clip(-(nrm @ light), 0, 1)[:, None]
        pts.append(p)
        cols.append((c * lam).astype(np.float32))
        scales_log.append(np.full((n,), np.log(rad * 0.35), np.float32))
    nb = 256
    gx, gy = np.meshgrid(np.linspace(-2, 2, 16), np.linspace(-2, 2, 16))
    bgz = rng.uniform(3.5, 5.0)
    tilt = rng.uniform(-0.35, 0.35, size=2)
    bgp = np.stack([gx.ravel(), gy.ravel(),
                    np.full(nb, bgz) + tilt[0] * gx.ravel() + tilt[1] * gy.ravel()], -1)
    bgp += rng.normal(0, 0.05, bgp.shape)
    pts.append(bgp.astype(np.float32))
    cols.append(_texture(rng, 16).reshape(-1, 3).astype(np.float32))
    scales_log.append(np.full((nb,), np.log(0.25), np.float32))
    if rng.uniform() < 0.7:  # a ground plane sweeping near -> far
        gx, gz = np.meshgrid(np.linspace(-2, 2, 16), np.linspace(0.6, bgz, 16))
        fp = np.stack([gx.ravel(), np.full(nb, rng.uniform(0.35, 0.7)), gz.ravel()], -1)
        fp += rng.normal(0, 0.03, fp.shape)
        pts.append(fp.astype(np.float32))
        cols.append(_texture(rng, 16).reshape(-1, 3).astype(np.float32))
        scales_log.append(np.log(0.06 + 0.05 * gz.ravel()).astype(np.float32))
    if rng.uniform() < 0.4:  # a side wall sweeping near -> far
        gy, gz = np.meshgrid(np.linspace(-2, 2, 16), np.linspace(0.6, bgz, 16))
        wall_x = rng.choice([-1.0, 1.0]) * rng.uniform(0.4, 0.8)
        wp = np.stack([np.full(nb, wall_x), gy.ravel(), gz.ravel()], -1)
        wp += rng.normal(0, 0.03, wp.shape)
        pts.append(wp.astype(np.float32))
        cols.append(_texture(rng, 16).reshape(-1, 3).astype(np.float32))
        scales_log.append(np.log(0.06 + 0.05 * gz.ravel()).astype(np.float32))
    pts, cols = np.concatenate(pts), np.concatenate(cols)
    scales_log = np.concatenate(scales_log)
    n = len(pts)
    if n < SCENE_CAP:
        pad = SCENE_CAP - n
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        cols = np.concatenate([cols, np.zeros((pad, 3), np.float32)])
        scales_log = np.concatenate([scales_log, np.full((pad,), np.log(1e-4), np.float32)])
    else:
        pts, cols, scales_log = pts[:SCENE_CAP], cols[:SCENE_CAP], scales_log[:SCENE_CAP]
    f = rng.uniform(0.9, 1.5) * res
    return SceneSplats(pts, cols, scales_log, n,
                       np.asarray([f, f, res / 2, res / 2], np.float32), float(bgz))


def scene_rotations(generator: torch.Generator) -> torch.Tensor:
    """The surfels' (SCENE_CAP, 4) unnormalised rotations, uniform in [0, 1)
    as `surfels.init_from_points` draws them."""
    return torch.rand((SCENE_CAP, 4), generator=generator)


@torch.no_grad()
def render_scene(splats: SceneSplats, rotations: torch.Tensor, res: int, device):
    """(rgb (res, res, 3), depth (res, res), valid) numpy of the scene seen
    from the identity camera (opacity sigmoid(5), SH degree 0, black
    background): depth = expected depth / alpha where alpha > 0.5, the
    wall's elsewhere; valid is all ones (the background is supervised)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    quats = rotations.to(device)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    scales = torch.exp(t(splats.scales_log))[:, None].expand(-1, 2)
    opac = torch.sigmoid(torch.full((SCENE_CAP,), 5.0, device=device))
    shs = sh_ops.rgb_to_sh(t(splats.colors))[:, None, :]
    alive = torch.arange(SCENE_CAP, device=device) < splats.n
    out = rasterize(t(splats.xyz), quats, scales, opac, torch.eye(4, device=device),
                    t(splats.intrins), res, res, shs=shs, sh_degree=0,
                    bg_color=torch.zeros(3, device=device), mask=alive)
    a = out.alpha.cpu().numpy()
    rgb = out.color.cpu().numpy()
    depth = out.depth.cpu().numpy() / np.maximum(a, 1e-6)
    valid = (a > 0.5).astype(np.float32)
    depth = depth * valid + splats.wall_depth * (1 - valid)
    return rgb, depth.astype(np.float32), np.ones_like(valid)


def make_scene(rng: np.random.Generator, res: int, rotations: torch.Tensor, device="cpu",
               n_blobs: Optional[int] = None):
    """One rendered scene: rgb (res, res, 3), depth (res, res), valid mask
    (numpy)."""
    return render_scene(scene_splats(rng, res, n_blobs), rotations, res, device)


def make_batch(rng: np.random.Generator, res: int, batch: int, rotations: torch.Tensor,
               device="cpu"):
    """(rgb (B, res, res, 3), depth (B, res, res), valid) of fresh scenes
    with per-scene brightness and noise jitter, on ``device``."""
    rgbs, deps, vals = [], [], []
    for _ in range(batch):
        r, d, v = make_scene(rng, res, rotations, device)
        r = np.clip(r * rng.uniform(0.7, 1.3) + rng.normal(0, 0.02, r.shape), 0, 1)
        rgbs.append(r.astype(np.float32))
        deps.append(d)
        vals.append(v)
    return tuple(torch.as_tensor(np.stack(x), device=device) for x in (rgbs, deps, vals))


class ScenePool:
    """Pre-rendered scenes; each batch draws scenes with replacement, flips
    half of them left-right and jitters brightness and noise."""

    def __init__(self, rng: np.random.Generator, res: int, size: int,
                 rotations: torch.Tensor, device="cpu"):
        self.rng, self.device = rng, device
        self.rgb = np.zeros((size, res, res, 3), np.float32)
        self.dep = np.zeros((size, res, res), np.float32)
        self.render_ms = []
        for i in range(size):
            t0 = time.perf_counter()
            self.rgb[i], self.dep[i], _ = make_scene(rng, res, rotations, device)
            self.render_ms.append((time.perf_counter() - t0) * 1e3)
            if i % 100 == 0:
                print(f"  scene pool {i}/{size}", flush=True)

    def batch(self, batch: int):
        rng = self.rng
        idx = rng.integers(0, len(self.rgb), size=batch)
        r, d = self.rgb[idx].copy(), self.dep[idx].copy()
        flip = rng.uniform(size=batch) < 0.5
        r[flip] = r[flip, :, ::-1]
        d[flip] = d[flip, :, ::-1]
        r = np.clip(r * rng.uniform(0.7, 1.3, size=(batch, 1, 1, 1))
                    + rng.normal(0, 0.02, r.shape), 0, 1).astype(np.float32)
        return tuple(torch.as_tensor(x, device=self.device)
                     for x in (r, d, np.ones_like(d, np.float32)))


def order_accuracy(disp, depth: np.ndarray, rng: np.random.Generator,
                   n_pairs: int = 2000) -> float:
    """Fraction of random pixel pairs (depths more than 0.05 apart) whose
    predicted order (larger disparity = nearer) matches the depth's."""
    h, w = depth.shape
    ii = rng.integers(0, h * w, size=(n_pairs, 2))
    d = depth.reshape(-1)[ii]
    p = np.asarray(disp).reshape(-1)[ii]
    keep = np.abs(d[:, 0] - d[:, 1]) > 0.05
    return float(((d[:, 0] < d[:, 1]) == (p[:, 0] > p[:, 1]))[keep].mean())


def train_step(model: DepthNet, opt: tc.AdamW, rgb: torch.Tensor, dep: torch.Tensor,
               val: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
               rank_wt: float = 1.0) -> torch.Tensor:
    """One step: depth_loss + rank_wt x ranking_loss over the pairs (ii,
    jj), backward, the optimiser's update. Returns the loss (0-d)."""
    model.zero_grad(set_to_none=True)
    disp = model(rgb.permute(0, 3, 1, 2))
    loss = depth_loss(disp, dep, val) + rank_wt * ranking_loss(disp, dep, val, ii, jj)
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(model: DepthNet, steps: int, lr: float) -> tc.AdamW:
    """clip_by_global_norm(1.0) then adamw(linear_onecycle_schedule(steps, lr))."""
    return tc.AdamW(model.parameters(), tc.linear_onecycle_schedule(steps, lr),
                    clip_norm=1.0)


@torch.no_grad()
def evaluate(model: DepthNet, res: int, batch: int, rotations: torch.Tensor, device,
             rounds: int = 4) -> Dict:
    """Held-out SSI-MAE and depth order accuracy of the net, and the order
    accuracy of the flow parallax of a static pair, on ``rounds`` fresh
    batches from ``np.random.default_rng(123)``."""
    rng = np.random.default_rng(123)
    maes, accs, accs_fp = [], [], []
    for _ in range(rounds):
        rgb, dep, val = make_batch(rng, res, batch, rotations, device)
        disp = model(rgb.permute(0, 3, 1, 2))
        maes.append(float(ssi_mae(disp, 1.0 / torch.clamp(dep, min=1e-3), val)))
        for b in range(rgb.shape[0]):
            depth_b = dep[b].cpu().numpy()
            accs.append(order_accuracy(disp[b].cpu().numpy(), depth_b, rng))
            gray = rgb[b].mean(-1)
            fp = depth_from_flow_parallax(torch.stack([gray, gray]))[0].cpu().numpy()
            accs_fp.append(order_accuracy(1.0 / np.maximum(fp, 1e-3), depth_b, rng))
    return {"ssi_mae": float(np.mean(maes)), "order_acc": float(np.mean(accs)),
            "flow_parallax_order_acc": float(np.mean(accs_fp))}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--rank_wt", type=float, default=1.0)
    ap.add_argument("--pool", type=int, default=512,
                    help="pre-rendered scene pool size (0: fresh every step)")
    ap.add_argument("--out", default=os.path.join(tc.WEIGHTS_OUT, "depthnet_synthetic.npz"))
    ap.add_argument("--init", default="",
                    help="warm-start from an existing weights .npz")
    ap.add_argument("--save_every", type=int, default=0,
                    help="write --out every N steps (0: only at the end)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train, save, evaluate. Returns every step's loss and wall ms (up to
    reading its loss), the pool's render ms per scene, the largest
    parameter change, the held-out scores, the output path and the trained
    net."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = tc.train_device(args.device)
    rng = np.random.default_rng(0)
    rotations = scene_rotations(torch.Generator().manual_seed(0))
    make_batch(rng, args.res, args.batch, rotations, device)  # the JAX script's init batch
    if args.init:
        model = load_depthnet(args.init, device=device)
        if model is None:
            raise FileNotFoundError(f"--init {args.init!r} does not exist")
        model.train()
        print(f"warm-start from {args.init}", flush=True)
    else:
        model = tc.flax_conv_init_(DepthNet(width=args.width),
                                   torch.Generator().manual_seed(0)).to(device)
    print(f"depthnet params: {tc.count_params(model) / 1e6:.2f}M", flush=True)
    before = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(model, args.steps, args.lr)
    pool = ScenePool(rng, args.res, args.pool, rotations, device) if args.pool else None
    pairs_gen = torch.Generator(device).manual_seed(1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)  # --save_every writes it
    hw = args.res * args.res
    out = {"loss": [], "step_ms": [], "render_ms": pool.render_ms if pool else []}
    t0 = time.time()
    for it in range(args.steps):
        rgb, dep, val = (pool.batch(args.batch) if pool
                         else make_batch(rng, args.res, args.batch, rotations, device))
        ii, jj = ranking_pairs(args.batch, hw, pairs_gen, device=device)
        ts = time.perf_counter()
        out["loss"].append(float(train_step(model, opt, rgb, dep, val, ii, jj, args.rank_wt)))
        out["step_ms"].append((time.perf_counter() - ts) * 1e3)
        if it % 100 == 0 or it == args.steps - 1:
            print(f"step {it}: loss={out['loss'][-1]:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if args.save_every and it and it % args.save_every == 0:
            save_weights(args.out, model)
    out["param_change"] = tc.max_param_change(model, before)
    save_weights(args.out, model)
    print(f"saved {args.out}", flush=True)
    out.update(evaluate(model.eval(), args.res, args.batch, rotations, device))
    print(f"held-out: ssi_mae={out['ssi_mae']:.4f} order_acc={out['order_acc']:.3f} "
          f"flow_parallax_order_acc={out['flow_parallax_order_acc']:.3f}", flush=True)
    out["out"], out["model"] = args.out, model
    return out


if __name__ == "__main__":
    main()
