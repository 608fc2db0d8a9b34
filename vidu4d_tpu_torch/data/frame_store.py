"""The database's frames held in device memory, and each training batch
gathered from them there: Stage 3's whole images and Stage 2's sampled
pixels.

A frame's read is a pure function of the frame and, for its flow, of the
pair's delta, yet `VidDataset.read_raw` redoes it on the host at every
step: the float16 maps widened to float32 and the feature map sampled in
float64. `FrameStore` does that work once per frame, at every pixel, with
the same code, and keeps the result on the trainer's device: float16 maps
as float16 (widened when a batch is gathered, which is exact), the sampled
features as float32, the per-frame scalars, every flow table (one tensor a
video, after a zero row) and the pixel grid. A batch's pairs and pixels
are drawn on the host by `PairBatcher.draw`, the draws of the map path, so
both paths see the same pairs and pixels and leave the rngs in the same
state. Whole images (``pixels_per_image`` -1) are then stacked on the
device from views of the store (`FrameStore.batch`); sampled pixels are
gathered there by one index a key from the draws' frame, flow-row and
pixel indices, copied to the device in one transfer
(`FrameStore.sampled_batch`). Neither copies image data from the host.

`FrameStore.build` returns None where the tables would take more than a
quarter of the device's free memory; the caller then keeps the memory-map
path. ``vidloader.COUNTS["store"]`` counts the frames served here,
``COUNTS["maps"]`` those read from the maps.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

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


def _flow_tables(ds: VidDataset) -> Tuple[List[tuple], torch.dtype]:
    """``ds``'s flow tables as (way, |delta|, memory map), in the order the
    store lays them out, and the dtype of that layout: float16 where every
    table is, else float32."""
    tables = [(way, d, a) for way, by_d in ds.flow.items() for d, a in by_d.items()]
    dtype = torch.float16 if all(a.dtype == np.float16 for *_, a in tables) else torch.float32
    return tables, dtype


def store_bytes(ds: VidDataset) -> int:
    """The bytes `VideoFrames` will hold for ``ds``, from its maps' shapes."""
    hw = ds.img_size[0] * ds.img_size[1]
    rgb = ds.mmap["rgb"]
    n = _kept_size(rgb) * (1 if rgb.ndim == 4 else 3)
    n += _kept_size(ds.mmap["mask"]) + _kept_size(ds.mmap["depth"])
    n += ds.num_frames * hw * ds.mmap["feature"].shape[-1] * 4
    tables, dtype = _flow_tables(ds)
    n += (1 + sum(len(a) for *_, a in tables)) * hw * 3 * (2 if dtype == torch.float16 else 4)
    n += ds.crop2raw.nbytes + ds.is_detected.nbytes + ds.num_frames * (4 + 4 + 8)
    return n + hw * 3 * 4  # the pixel grid


def free_bytes(device: torch.device) -> int:
    """Free memory of ``device``: the card's, or the host's."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class VideoFrames:
    """One video's frames on ``device``, every pixel as `read_raw` gives
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
        # every flow table in one tensor after a zero row (the flow where a
        # table is missing), so that a batch of sampled pixels takes its
        # flow in one index; ``flow`` holds views of it, ``flow_start`` each
        # table's first row
        tables, dtype = _flow_tables(ds)
        self.flow_rows = torch.zeros((1 + sum(len(a) for *_, a in tables), hw, 3),
                                     dtype=dtype, device=device)
        self.flow = {way: {} for way in ds.flow}
        self.flow_start = {}
        start = 1
        for way, d, a in tables:
            self.flow_rows[start:start + len(a)] = flat(a)
            self.flow[way][d] = self.flow_rows[start:start + len(a)]
            self.flow_start[way, d] = start
            start += len(a)
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
        self.width = ds.img_size[1]

    def tensors(self) -> List[torch.Tensor]:
        return [v for v in vars(self).values() if torch.is_tensor(v)]

    @span("data.read")
    def read(self, idx: int, delta: int) -> Dict[str, torch.Tensor]:
        """Views of frame ``idx`` and its flow towards ``idx + delta``, under
        `read_raw`'s keys (and ``frameid``)."""
        COUNTS["store"] += 1
        way, d, row = VidDataset.flow_row(idx, delta)
        table = self.flow[way].get(d)
        flow = self.flow_rows[0] if table is None else table[row]
        mask = self.mask[idx]
        return {"rgb": self.rgb[idx], "mask": mask[:, :1], "vis2d": mask[:, 1:2],
                "depth": self.depth[idx], "flow": flow[:, :2], "flow_uct": flow[:, 2:3],
                "feature": self.feature[idx], "crop2raw": self.crop2raw[idx],
                "is_detected": self.is_detected[idx], "dataid": self.dataid[idx],
                "frameid_sub": self.frameid_sub[idx], "hxy": self.hxy,
                "frameid": self.frameid[idx]}


class FrameStore:
    """Every video's `VideoFrames`; `batch` stacks a batch of whole images
    from them, `sampled_batch` gathers a batch of sampled pixels."""

    def __init__(self, datasets: Sequence[VidDataset], frame_offset_raw: Sequence[int],
                 device: torch.device):
        self.device = torch.device(device)
        self.videos = [VideoFrames(ds, int(frame_offset_raw[ds.dataid]), device)
                       for ds in datasets]
        self.nbytes = sum(t.numel() * t.element_size()
                          for video in self.videos for t in video.tensors())

    @classmethod
    def build(cls, datasets: Sequence[VidDataset], frame_offset_raw: Sequence[int],
              device) -> Optional["FrameStore"]:
        """The store of ``datasets`` on ``device``, or None where it would
        take more than ``MAX_SHARE`` of the device's free memory."""
        device = torch.device(device)
        if not datasets:
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

    def sampled_batch(self, draws: List[tuple]) -> Dict[str, torch.Tensor]:
        """The flattened batch of sampled-pixel ``draws`` (`PairBatcher.draw`,
        with each frame's (x, y) pixels) with its global ``frameid``: the
        keys, shapes, dtypes and values of
        ``compute_frameid(flatten_pairs(next_batch()))`` on the device, in
        fresh tensors. The items' indices go to the device in one transfer,
        grouped by video; each key is then one index of a video's table, and
        with several videos the groups are put back in draw order."""
        with span("data.read"):
            vids, items = self._sampled_items(draws)
        COUNTS["store"] += len(vids)
        with span("data.copy"):
            group = np.argsort(vids, kind="stable")
            index = torch.from_numpy(np.concatenate([items[group].ravel(), np.argsort(group)]))
            if self.device.type == "cuda":
                index = index.pin_memory().to(self.device, non_blocking=True)
            else:
                index = index.to(self.device)
            grouped = index[:items.size].view(items.shape)
            cuts = [0, *(np.flatnonzero(np.diff(vids[group])) + 1), len(vids)]
            parts = [self._gather(self.videos[vids[group[a]]], grouped[a:b])
                     for a, b in zip(cuts, cuts[1:])]
            if len(parts) == 1:
                return parts[0]
            order = index[items.size:]
            return {k: torch.cat([p[k] for p in parts])[order] for k in parts[0]}

    def _sampled_items(self, draws: List[tuple]):
        """Each item's video (2M,) and, in an int64 (2M, 2 + N) array, its
        frame, its row of the video's ``flow_rows`` (0, the zero row, where
        the table is missing) and its N raster pixels; in draw order."""
        vids, heads, xys = [], [], []
        for vid, t, delta, xy0, xy1 in draws:
            starts = self.videos[vid].flow_start
            for idx, d, xy in ((t, delta, xy0), (t + delta, -delta, xy1)):
                way, ad, row = VidDataset.flow_row(idx, d)
                vids.append(vid)
                heads.append((idx, starts[way, ad] + row if (way, ad) in starts else 0))
                xys.append(xy)
        vids = np.asarray(vids)
        xy = np.stack(xys).astype(np.int64)
        width = np.asarray([v.width for v in self.videos])[vids, None]
        return vids, np.concatenate([np.asarray(heads, np.int64),
                                     xy[..., 1] * width + xy[..., 0]], 1)

    @staticmethod
    def _gather(video: VideoFrames, items: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The keys of ``items`` (`_sampled_items`' rows, on the device) of
        one video under `read_raw`'s keys (and ``frameid``), widened to
        float32."""
        frame, frow, pixel = items[:, 0], items[:, 1], items[:, 2:]
        at = lambda table, rows: table[rows[:, None], pixel]
        mask, flow = at(video.mask, frame), at(video.flow_rows, frow)
        out = {"rgb": at(video.rgb, frame), "mask": mask[..., :1], "vis2d": mask[..., 1:2],
               "depth": at(video.depth, frame), "flow": flow[..., :2],
               "flow_uct": flow[..., 2:3], "feature": at(video.feature, frame),
               "crop2raw": video.crop2raw[frame], "is_detected": video.is_detected[frame],
               "dataid": video.dataid[frame], "frameid_sub": video.frameid_sub[frame],
               "hxy": video.hxy[pixel], "frameid": video.frameid[frame]}
        return {k: v.to(torch.float32, memory_format=torch.contiguous_format)
                if v.is_floating_point() else v for k, v in out.items()}
