"""Score DepthNet weights without training them (`scripts/eval_depthnet.py`).

Loads an .npz of `train_depthnet` (or the shipped
``vidu4d_tpu/weights/depthnet_synthetic.npz``) and reruns its held-out
evaluation: SSI-MAE and depth-order accuracy of the net, beside the order
accuracy of the flow-parallax fallback, on the seed-123 scenes
(`train_depthnet.evaluate`, which draws them and their pixel pairs from
``np.random.default_rng(123)`` in the JAX script's order).

    python -m vidu4d_tpu_torch.preprocess.eval_depthnet \\
        --weights vidu4d_tpu/weights/depthnet_synthetic.npz [--device cpu]

The flags and defaults are the JAX script's, plus ``--device`` (the card
unless "cpu"). The scenes' surfel rotations are ``main``'s ``rotations``,
else `train_depthnet.scene_rotations` of a generator seeded with 0, as the
trainer draws them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch

from vidu4d_tpu_torch.preprocess.depthnet import DepthNet
from vidu4d_tpu_torch.preprocess.layers import load_net
from vidu4d_tpu_torch.preprocess.train_common import train_device
from vidu4d_tpu_torch.preprocess.train_depthnet import evaluate, scene_rotations


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         rotations: Optional[torch.Tensor] = None) -> Dict:
    """Load, evaluate, print. Returns {"ssi_mae", "order_acc",
    "flow_parallax_order_acc"}. A weights file that does not exist
    raises."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = train_device(args.device)
    model = load_net(DepthNet(width=args.width), args.weights, device)
    if model is None:
        raise FileNotFoundError(f"--weights {args.weights!r} does not exist")
    if rotations is None:
        rotations = scene_rotations(torch.Generator().manual_seed(0))
    out = evaluate(model, args.res, args.batch, rotations, device, rounds=args.rounds)
    print(f"held-out: ssi_mae={out['ssi_mae']:.4f} order_acc={out['order_acc']:.3f} "
          f"flow_parallax_order_acc={out['flow_parallax_order_acc']:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
