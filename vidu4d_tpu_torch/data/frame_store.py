"""Whole-image frames held in device memory, and each Stage-3 batch
gathered from them there.

With whole-image items (``pixels_per_image`` -1) a frame's read is a pure
function of the frame and, for its flow, of the pair's delta, yet
`VidDataset.read_raw` redoes it on the host at every step: the float16
maps widened to float32 and the feature map sampled at every pixel in
float64. `FrameStore` does that work once per frame, with the same code,
and keeps the result on the trainer's device: float16 maps as float16
(widened when a batch is gathered, which is exact), the sampled features
as float32, the per-frame scalars, every flow table and the pixel grid.
A batch's pairs are drawn on the host by `PairBatcher.draw`, the draws of
the map path, so both paths see the same pairs and leave the rng in the
same state; the batch is then stacked on the device from views of the
store: one stack a key and no host-to-device copy of image data.

`FrameStore.build` chooses the path from its input: whole images whose
tables fit in a quarter of the device's free memory; otherwise None, and
the caller keeps the memory-map path. ``vidloader.COUNTS["store"]``
counts the frames served here, ``COUNTS["maps"]`` those read from the
maps.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch.data.vidloader import COUNTS, VidDataset
from vidu4d_tpu_torch.utils.profiler import span

# the share of the device's free memory the store may take
MAX_SHARE = 0.25


def _kept(a: np.ndarray) -> np.ndarray:
    """A map as the store keeps it: float16 as it is, else float32 (the
    read path's own cast); a copy, in host memory."""
    return np.array(a, np.float16 if a.dtype == np.float16 else np.float32)


def _kept_size(a: np.ndarray) -> int:
    return a.size * (2 if a.dtype == np.float16 else 4)


def store_bytes(ds: VidDataset) -> int:
    """The bytes `VideoFrames` will hold for ``ds``, from its maps' shapes."""
    hw = ds.img_size[0] * ds.img_size[1]
    rgb = ds.mmap["rgb"]
    n = _kept_size(rgb) * (1 if rgb.ndim == 4 else 3)
    n += _kept_size(ds.mmap["mask"]) + _kept_size(ds.mmap["depth"])
    n += ds.num_frames * hw * ds.mmap["feature"].shape[-1] * 4
    n += sum(_kept_size(t) for way in ds.flow.values() for t in way.values())
    n += ds.crop2raw.nbytes + ds.is_detected.nbytes + ds.num_frames * (4 + 4 + 8)
    return n + hw * 3 * 4 * 2  # the pixel grid, the zero flow


def free_bytes(device: torch.device) -> int:
    """Free memory of ``device``: the card's, or the host's."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class VideoFrames:
    """One video's whole-image frames on ``device``, as `read_raw` gives
    them; ``frame_offset`` is the video's first global frame id."""

    def __init__(self, ds: VidDataset, frame_offset: int, device: torch.device):
        hw = ds.img_size[0] * ds.img_size[1]
        # (frames, H * W, ...) as `read_raw` flattens each frame
        flat = lambda a: torch.from_numpy(
            _kept(a).reshape((a.shape[0], hw) + a.shape[3:])).to(device)
        rgb = ds.mmap["rgb"]
        self.rgb = flat(rgb if rgb.ndim == 4 else np.repeat(rgb[..., None], 3, -1))
        self.mask = flat(ds.mmap["mask"])
        self.depth = flat(ds.mmap["depth"][..., None])
        self.flow = {way: {d: flat(a) for d, a in tables.items()}
                     for way, tables in ds.flow.items()}
        self.no_flow = torch.zeros(hw, 3, dtype=torch.float32, device=device)
        hxy = ds.whole_hxy()
        self.hxy = torch.from_numpy(hxy.astype(np.float32)).to(device)
        t = ds.num_frames
        self.feature = torch.empty(t, hw, ds.mmap["feature"].shape[-1], dtype=torch.float32,
                                   device=device)
        for i in range(t):
            self.feature[i] = torch.from_numpy(ds.sample_feature(i, hxy))
        self.crop2raw = torch.from_numpy(ds.crop2raw).to(device)
        self.is_detected = torch.from_numpy(ds.is_detected).to(device)
        self.dataid = torch.full((t,), ds.dataid, dtype=torch.int32, device=device)
        self.frameid_sub = torch.arange(t, dtype=torch.int32, device=device)
        self.frameid = self.frameid_sub.long() + frame_offset

    def tensors(self) -> List[torch.Tensor]:
        return ([v for v in vars(self).values() if torch.is_tensor(v)]
                + [t for tables in self.flow.values() for t in tables.values()])

    @span("data.read")
    def read(self, idx: int, delta: int) -> Dict[str, torch.Tensor]:
        """Views of frame ``idx`` and its flow towards ``idx + delta``, under
        `read_raw`'s keys (and ``frameid``)."""
        COUNTS["store"] += 1
        way, d, row = VidDataset.flow_row(idx, delta)
        table = self.flow[way].get(d)
        flow = self.no_flow if table is None else table[row]
        mask = self.mask[idx]
        return {"rgb": self.rgb[idx], "mask": mask[:, :1], "vis2d": mask[:, 1:2],
                "depth": self.depth[idx], "flow": flow[:, :2], "flow_uct": flow[:, 2:3],
                "feature": self.feature[idx], "crop2raw": self.crop2raw[idx],
                "is_detected": self.is_detected[idx], "dataid": self.dataid[idx],
                "frameid_sub": self.frameid_sub[idx], "hxy": self.hxy,
                "frameid": self.frameid[idx]}


class FrameStore:
    """Every video's `VideoFrames`; `batch` gathers a batch from them."""

    def __init__(self, datasets: Sequence[VidDataset], frame_offset_raw: Sequence[int],
                 device: torch.device):
        self.videos = [VideoFrames(ds, int(frame_offset_raw[ds.dataid]), device)
                       for ds in datasets]
        self.nbytes = sum(t.numel() * t.element_size()
                          for video in self.videos for t in video.tensors())

    @classmethod
    def build(cls, datasets: Sequence[VidDataset], frame_offset_raw: Sequence[int],
              device) -> Optional["FrameStore"]:
        """The store of ``datasets`` on ``device``, or None where their items
        are sampled pixels or the store would take more than ``MAX_SHARE``
        of the device's free memory."""
        device = torch.device(device)
        if not datasets or any(ds.pixels_per_image != -1 for ds in datasets):
            return None
        if sum(store_bytes(ds) for ds in datasets) > MAX_SHARE * free_bytes(device):
            return None
        return cls(datasets, frame_offset_raw, device)

    def batch(self, draws: List[tuple]) -> Dict[str, torch.Tensor]:
        """The flattened batch of ``draws`` (`PairBatcher.draw`) with its
        global ``frameid``: the keys, shapes, dtypes and values of
        ``compute_frameid(flatten_pairs(next_batch()))`` on the device, in
        fresh tensors."""
        frames = []
        for vid, t, delta, *_ in draws:
            video = self.videos[vid]
            frames += [video.read(t, delta), video.read(t + delta, -delta)]
        with span("data.copy"):
            out = {}
            for k in frames[0]:
                v = torch.stack([f[k] for f in frames])
                out[k] = v.float() if v.is_floating_point() else v
            return out
