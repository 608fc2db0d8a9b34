"""Frame metadata shared by all time-conditioned modules
(`vidu4d_tpu/data/frame_info.py`).

Mirrors the reference's ``frame_info`` dict (`lab4d/nnutils/embedding.py:137+`):
videos are concatenated into one global (raw) frame index space; models may
train on a filtered subset (``frame_mapping``). Stored as tuples, as in the
JAX package, so it stays hashable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FrameInfo(NamedTuple):
    frame_offset: tuple  # (num_vids+1,) cumulative counts of *filtered* frames
    frame_mapping: tuple  # (M,) raw frame ids of the filtered frames
    frame_offset_raw: tuple  # (num_vids+1,) cumulative counts of raw frames

    @property
    def num_vids(self) -> int:
        return len(self.frame_offset) - 1

    @property
    def num_frames_raw(self) -> int:
        return self.frame_offset_raw[-1]

    @property
    def max_vid_len(self) -> int:
        off = np.asarray(self.frame_offset)
        return int((off[1:] - off[:-1]).max())

    @staticmethod
    def single_video(num_frames: int) -> "FrameInfo":
        return FrameInfo(
            frame_offset=(0, num_frames),
            frame_mapping=tuple(range(num_frames)),
            frame_offset_raw=(0, num_frames),
        )

    def raw_fid_to_vid(self) -> np.ndarray:
        """(N_raw,) video id of each raw frame."""
        off = np.asarray(self.frame_offset_raw)
        raw = np.arange(off[-1])
        return (np.searchsorted(off, raw, side="right") - 1).astype(np.int32)
