"""Cells' sizes cut for a test process."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# a cell's sizes cut for a test process: 32^2 frames, 8 frames, a 2048-surfel
# store in 4096 slots
SMALL = {"stage3": {"flags": ["--train_res", "32"],
                    "opts": {"gs_init_samples": 2048, "gs_capacity": 4096}, "frames": 8}}
CELLS = {"s3-gs-bob.train": "stage3", "s3-gs-bob.late": "stage3"}
