"""Training observability (`vidu4d_tpu/utils/logging.py`): scalars and
images to tensorboardX, and the console loss dump sorted by magnitude
every 100 steps. Without tensorboardX installed the logger writes nothing
(the console dump still prints)."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


class ScalarLogger:
    def __init__(self, logdir: str, console_every: int = 100):
        self.console_every = console_every
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.writer = None
        else:
            self.writer = SummaryWriter(os.path.join(logdir, "tb"))

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_scalar(f"{prefix}{k}", float(v), step)

    def log_loss_dict(self, step: int, scalars: Dict[str, float]) -> None:
        """The trainers' log_fn: (step, {name: value})."""
        self.scalars(step, scalars, prefix="loss/")
        if step % self.console_every == 0 and scalars:
            top = sorted(scalars.items(), key=lambda kv: -abs(float(kv[1])))
            msg = " ".join(f"{k}={float(v):.5f}" for k, v in top[:10])
            print(f"step {step}: {msg}")

    def image(self, step: int, tag: str, img) -> None:
        """An (H, W, 1 or 3) image in [0, 1]."""
        if self.writer is None:
            return
        arr = np.clip(np.asarray(img, dtype=float), 0, 1)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3):
            arr = arr.transpose(2, 0, 1)
        self.writer.add_image(tag, arr, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def dump_opts_json(save_dir: str, opts) -> None:
    """Write the trainer's option dict to ``<save_dir>/opts.json``, leaving
    out values JSON cannot hold (`logging.py:51`)."""
    clean = {}
    for k, v in dict(opts).items():
        try:
            json.dumps(v)
        except TypeError:
            continue
        clean[k] = v
    with open(os.path.join(save_dir, "opts.json"), "w") as f:
        json.dump(clean, f, indent=1, sort_keys=True)
