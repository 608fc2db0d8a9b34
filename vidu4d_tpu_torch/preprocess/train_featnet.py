"""Train the dense registration-descriptor net (the DINOv2 slot) on
procedurally generated warp pairs (`scripts/train_featnet.py`).

Objective: symmetric dense InfoNCE (`featnet.info_nce_pair`): pixels
related by the known synthetic flow must embed nearby, every other sampled
pixel is an in-batch negative. The pairs are `train_raft.make_batch`'s. The
held-out match accuracy (argmax similarity within 4 px) is compared with
the HOG + colour descriptor (`features.hog_color_features`).

    python -m vidu4d_tpu_torch.preprocess.train_featnet --steps 1500 \\
        [--out weights_out/featnet_synthetic.npz] [--device cpu]

The flags and defaults are the JAX script's, except ``--out`` (under
``weights_out/``, never over the shipped file; ``$VIDU4D_FEATNET_NPZ``
selects another one) and ``--device`` (the card unless "cpu").
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
from vidu4d_tpu_torch.preprocess.featnet import (
    FeatNet,
    info_nce_pair,
    match_accuracy,
    save_weights,
)
from vidu4d_tpu_torch.preprocess.features import hog_color_features
from vidu4d_tpu_torch.preprocess.train_raft import make_batch, nchw


def sample_correspondences(rng: np.random.Generator, flow: np.ndarray, n_pts: int, res: int,
                           margin: float = 6.0):
    """(xy1, xy2), each (n_pts, 2): points in img1 and their matches
    xy1 - flow(xy1) in img2 (nearest-pixel flow; img2 is img1 sampled at
    x + flow(x), so a point y of img1 appears near y - flow(y)), both
    ``margin`` inside the image; short draws repeat (`train_featnet.py:39`)."""
    xs = rng.uniform(margin, res - margin, size=(n_pts * 3, 2)).astype(np.float32)
    xi = xs.astype(np.int32)
    xy2 = xs - flow[xi[:, 1], xi[:, 0]]
    ok = ((xy2[:, 0] > margin) & (xy2[:, 0] < res - margin)
          & (xy2[:, 1] > margin) & (xy2[:, 1] < res - margin))
    idx = np.nonzero(ok)[0][:n_pts]
    if len(idx) < n_pts:
        idx = np.concatenate([idx, idx[: n_pts - len(idx)]])
    return xs[idx], xy2[idx]


def hwc(feat: torch.Tensor) -> torch.Tensor:
    """(B, D, h, w) -> (B, h, w, D)."""
    return feat.permute(0, 2, 3, 1)


def train_step(model: FeatNet, opt: tc.AdamW, img1: torch.Tensor, img2: torch.Tensor,
               xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """One step: the mean over the batch of each pair's InfoNCE, backward,
    the optimiser's update. Returns the loss (0-d)."""
    model.zero_grad(set_to_none=True)
    f1, f2 = hwc(model(nchw(img1))), hwc(model(nchw(img2)))
    loss = torch.stack([info_nce_pair(f1[b], f2[b], xy1[b], xy2[b])
                        for b in range(f1.shape[0])]).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(model: FeatNet, steps: int, lr: float) -> tc.AdamW:
    """adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps), weight
    decay 1e-5), warmup = min(100, max(1, steps // 10))."""
    warmup = min(100, max(1, steps // 10))
    return tc.AdamW(model.parameters(), tc.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1)), weight_decay=1e-5)


def batch_correspondences(rng: np.random.Generator, flow: torch.Tensor, n_pts: int, res: int,
                          device):
    """`sample_correspondences` for every image of a batch: (xy1, xy2), each
    (B, n_pts, 2) on ``device``."""
    pairs = [sample_correspondences(rng, f, n_pts, res) for f in flow.cpu().numpy()]
    return tuple(torch.as_tensor(np.stack([p[i] for p in pairs]), device=device)
                 for i in (0, 1))


@torch.no_grad()
def evaluate(model: FeatNet, res: int, device, rounds: int = 8) -> Dict:
    """Held-out match accuracy (<= 4 px among 256 candidates) of the net and
    of the HOG + colour descriptor (at half resolution, as the net's), on
    ``rounds`` single pairs from ``np.random.default_rng(777)``."""
    rng = np.random.default_rng(777)
    accs_net, accs_hog = [], []
    for _ in range(rounds):
        i1, i2, fl = make_batch(rng, res, 1, device=device)
        xy1, xy2 = sample_correspondences(rng, fl[0].cpu().numpy(), 256, res)
        accs_net.append(match_accuracy(hwc(model(nchw(i1)))[0], hwc(model(nchw(i2)))[0],
                                       xy1, xy2))
        accs_hog.append(match_accuracy(hog_color_features(i1[0], out_res=res // 2),
                                       hog_color_features(i2[0], out_res=res // 2), xy1, xy2))
    return {"match_acc_featnet": float(np.mean(accs_net)),
            "match_acc_hog": float(np.mean(accs_hog))}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pts", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=os.path.join(tc.WEIGHTS_OUT, "featnet_synthetic.npz"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train, save, evaluate. Returns every step's loss and wall ms (up to
    reading its loss), the largest parameter change, the held-out match
    accuracies, the output path and the trained net."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = tc.train_device(args.device)
    model = tc.flax_conv_init_(FeatNet(), torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    make_batch(rng, args.res, args.batch)  # the JAX script's init batch
    print(f"FeatNet params: {tc.count_params(model) / 1e6:.2f}M", flush=True)
    before = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(model, args.steps, args.lr)
    out = {"loss": [], "step_ms": []}
    t0 = time.time()
    for it in range(args.steps):
        img1, img2, flow = make_batch(rng, args.res, args.batch, device=device)
        xy1, xy2 = batch_correspondences(rng, flow, args.pts, args.res, device)
        ts = time.perf_counter()
        out["loss"].append(float(train_step(model, opt, img1, img2, xy1, xy2)))
        out["step_ms"].append((time.perf_counter() - ts) * 1e3)
        if it % 50 == 0:
            print(f"step {it}: loss {out['loss'][-1]:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
    out["param_change"] = tc.max_param_change(model, before)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_weights(args.out, model)
    print(f"saved {args.out}", flush=True)
    out.update(evaluate(model.eval(), args.res, device))
    print(f"held-out match acc (<=4px, 256 candidates): featnet "
          f"{out['match_acc_featnet']:.3f}  hog {out['match_acc_hog']:.3f}", flush=True)
    out["out"], out["model"] = args.out, model
    return out


if __name__ == "__main__":
    main()
