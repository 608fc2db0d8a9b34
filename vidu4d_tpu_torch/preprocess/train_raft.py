"""Train RAFT-small on procedurally generated warps (`scripts/train_raft.py`).

Random multi-scale textures warped by random smooth flows (affine +
gaussian-bump displacement fields), with photometric jitter on the warped
view; the gamma-weighted L1 over every update iteration supervises the
net (`raft.sequence_loss`). The held-out EPE is compared with pyramidal LK
(`flow.lk_flow`).

    python -m vidu4d_tpu_torch.preprocess.train_raft --steps 2000 \\
        [--out weights_out/raft_small_synthetic.npz] [--device cpu]

The flags and defaults are the JAX script's, except ``--out`` (it writes
under ``weights_out/``, never over the shipped ``vidu4d_tpu/weights/``
file, which the port's loaders keep reading; point
``$VIDU4D_RAFT_NPZ`` at a new file to use it) and ``--device`` (the card
unless "cpu"). The batches are drawn on the host from
``np.random.default_rng(0)`` as the JAX script draws them, the parameters
from a ``torch.Generator`` seeded 0 with flax's initialisers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch.preprocess import train_common as tc
from vidu4d_tpu_torch.preprocess.flow import lk_flow
from vidu4d_tpu_torch.preprocess.ops import resize_hwc
from vidu4d_tpu_torch.preprocess.raft import RaftSmall, save_weights, sequence_loss


def random_texture(rng: np.random.Generator, res: int, batch: int) -> np.ndarray:
    """(batch, res, res, 3) textures in [0, 1]: upsampled noise octaves 4 ..
    64, each weighted 1 / sqrt(scale), min-max normalised per image."""
    img = np.zeros((batch, res, res, 3), np.float32)
    for scale in (4, 8, 16, 32, 64):
        noise = rng.normal(size=(batch, scale, scale, 3)).astype(np.float32)
        img += resize_hwc(torch.from_numpy(noise), (res, res)).numpy() / np.sqrt(scale)
    img -= img.min(axis=(1, 2, 3), keepdims=True)
    img /= np.maximum(img.max(axis=(1, 2, 3), keepdims=True), 1e-6)
    return img


def random_flow(rng: np.random.Generator, res: int, batch: int, max_disp: float) -> np.ndarray:
    """(batch, res, res, 2) smooth flows: an affine field plus 1-3 gaussian
    bumps, clipped to +-2 max_disp."""
    flow = np.zeros((batch, res, res, 2), np.float32)
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    xy = np.stack([xx, yy], -1).astype(np.float32)
    c = xy - res / 2
    for b in range(batch):
        a = rng.normal(size=(2, 2)).astype(np.float32) * 0.03
        t = rng.uniform(-max_disp, max_disp, size=(2,)).astype(np.float32)
        flow[b] = c @ a.T + t
        for _ in range(rng.integers(1, 4)):
            ctr = rng.uniform(0, res, size=(2,))
            sig = rng.uniform(res / 8, res / 3)
            amp = rng.uniform(-max_disp, max_disp, size=(2,))
            g = np.exp(-np.sum((xy - ctr) ** 2, -1) / (2 * sig ** 2))
            flow[b] += g[..., None] * amp
    return np.clip(flow, -max_disp * 2, max_disp * 2)


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of (B, H, W, C) images: out(x) = img(x + flow(x)),
    bilinear, the sample point clamped to the image."""
    b, h, w, c = img.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    sx = torch.clamp(xx[None] + flow[..., 0], 0, w - 1)
    sy = torch.clamp(yy[None] + flow[..., 1], 0, h - 1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    wx, wy = sx - x0, sy - y0
    flat = img.reshape(b, -1, c)

    def tap(yi, xi):
        idx = (yi * w + xi).long().reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    return (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + tap(y0, x1) * (wx * (1 - wy))[..., None]
            + tap(y1, x0) * ((1 - wx) * wy)[..., None]
            + tap(y1, x1) * (wx * wy)[..., None])


def make_batch(rng: np.random.Generator, res: int, batch: int, max_disp: float = 12.0,
               device="cpu"):
    """(img1, img2, flow) on ``device``: textures (B, res, res, 3), their
    backward warps by the flow with brightness and noise jitter, and the
    flows (B, res, res, 2): img1(x) corresponds to img2(x + flow(x))."""
    img1 = random_texture(rng, res, batch)
    flow = random_flow(rng, res, batch, max_disp)
    img2 = warp_image(torch.from_numpy(img1), torch.from_numpy(flow)).numpy()
    img2 = np.clip(img2 * rng.uniform(0.8, 1.2) + rng.normal(0, 0.02, img2.shape),
                   0, 1).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (img1, img2, flow))


def nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2)


def train_step(model: RaftSmall, opt: tc.AdamW, img1: torch.Tensor, img2: torch.Tensor,
               gt: torch.Tensor, gamma: float = 0.8):
    """One step: the sequence loss of every iteration's flow, backward, the
    optimiser's update. Returns (loss, last iteration's EPE), 0-d tensors."""
    model.zero_grad(set_to_none=True)
    loss, epe = sequence_loss(model(nchw(img1), nchw(img2), all_iters=True), gt, gamma)
    loss.backward()
    opt.step()
    return loss.detach(), epe.detach()


def make_optimizer(model: RaftSmall, steps: int, lr: float) -> tc.AdamW:
    """clip_by_global_norm(1.0) then adamw(linear_onecycle_schedule(steps, lr))."""
    return tc.AdamW(model.parameters(), tc.linear_onecycle_schedule(steps, lr),
                    clip_norm=1.0)


@torch.no_grad()
def evaluate(model: RaftSmall, res: int, batch: int, device, rounds: int = 4) -> Dict:
    """Held-out mean EPE of the net and of pyramidal LK on ``rounds``
    batches from ``np.random.default_rng(123)``."""
    rng = np.random.default_rng(123)
    epes_raft, epes_lk = [], []
    for _ in range(rounds):
        img1, img2, gt = make_batch(rng, res, batch, device=device)
        pred = model(nchw(img1), nchw(img2))
        epes_raft.append(float(torch.mean(torch.linalg.vector_norm(pred - gt, dim=-1))))
        for b in range(img1.shape[0]):
            fl = lk_flow(img1[b], img2[b])
            epes_lk.append(float(torch.mean(torch.linalg.vector_norm(fl - gt[b], dim=-1))))
    return {"epe_raft": float(np.mean(epes_raft)), "epe_lk": float(np.mean(epes_lk))}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=os.path.join(tc.WEIGHTS_OUT, "raft_small_synthetic.npz"))
    ap.add_argument("--gamma", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train, save, evaluate. Returns the losses and EPEs of every step,
    each step's wall ms (up to reading its loss), the largest parameter
    change, the held-out EPEs, the output path and the trained net."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = tc.train_device(args.device)
    rng = np.random.default_rng(0)
    model = tc.flax_conv_init_(RaftSmall(), torch.Generator().manual_seed(0)).to(device)
    make_batch(rng, args.res, args.batch)  # the JAX script's init batch
    print(f"raft-small params: {tc.count_params(model) / 1e6:.2f}M")
    before = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(model, args.steps, args.lr)
    out = {"loss": [], "epe": [], "step_ms": []}
    t0 = time.time()
    for it in range(args.steps):
        img1, img2, gt = make_batch(rng, args.res, args.batch, device=device)
        ts = time.perf_counter()
        loss, epe = train_step(model, opt, img1, img2, gt, args.gamma)
        out["loss"].append(float(loss))  # reads the loss after the update's kernels
        out["step_ms"].append((time.perf_counter() - ts) * 1e3)
        out["epe"].append(float(epe))
        if it % 100 == 0 or it == args.steps - 1:
            print(f"step {it}: loss={out['loss'][-1]:.4f} epe={out['epe'][-1]:.3f}px "
                  f"({time.time() - t0:.0f}s)", flush=True)
    out["param_change"] = tc.max_param_change(model, before)
    save_weights(model, args.out)
    print(f"saved {args.out}")
    out.update(evaluate(model.eval(), args.res, args.batch, device))
    print(f"held-out EPE: raft={out['epe_raft']:.3f}px lk={out['epe_lk']:.3f}px")
    out["out"], out["model"] = args.out, model
    return out


if __name__ == "__main__":
    main()
