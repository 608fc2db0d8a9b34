"""Video dataset: mmap'd npy frame data + pair sampling
(`vidu4d_tpu/data/vidloader.py`).

Reads the Stage-1 on-disk contract:

    database/processed/{JPEGImages,Annotations,FlowFW_d,FlowBW_d,Depth,
                        Features,Cameras}/Full-Resolution/<seqname>/
        {crop,full}-256.npy            (T,H,W,3) rgb, fp16, 0..1
        Annotations/.../{prefix}.npy   (T,H,W,2) [mask, vis2d]
        .../{prefix}-crop2raw.npy      (T,4)
        .../{prefix}-is_detected.npy   (T,)
        FlowFW_d/.../{prefix}.npy      (T//d,H,W,3) [flow_xy, uncertainty]
        Depth/.../{prefix}.npy         (T,H,W) fp16
        Features/.../{prefix}-{feature_type}-01.npy  (T,112,112,16)
        Cameras/.../00.npy, 01-canonical.npy         (T,4,4)

Pairs (frame t, t+delta) with delta sampled from {1} + {2,4,8} gated by
divisibility (`vidloader.py:179-195`). An item is a whole image in raster
order (``pixels_per_image`` -1, Stage 3) or ``pixels_per_image`` pixels
drawn without replacement (`RangeSampler`, Stage 2), gathered from the
memory maps by numpy. The rng draws are the JAX package's, so the same
seed gives the same pairs and pixels. `PairBatcher.draw` makes a batch's
draws apart from its reads, so `data.frame_store` serves the same draws
from device memory, whole images and sampled pixels alike; the trainers
read from the maps only where the store does not fit.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from vidu4d_tpu_torch.utils.profiler import span

# the pair offsets besides 1 (`vidloader.py:179-195`)
DELTAS = (2, 4, 8)

# frames served to batches: "maps" read by `VidDataset.read_raw` from the
# memory maps, "store" by `data.frame_store` from device memory
COUNTS = {"maps": 0, "store": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def bilinear_interp(feat: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Bilinear sample feat (H, W, C) at float pixel coords xy (N, 2)."""
    h, w = feat.shape[:2]
    x = np.clip(xy[:, 0], 0, w - 1.000001)
    y = np.clip(xy[:, 1], 0, h - 1.000001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    out = (
        feat[y0, x0] * (1 - wx) * (1 - wy)
        + feat[y0, x1] * wx * (1 - wy)
        + feat[y1, x0] * (1 - wx) * wy
        + feat[y1, x1] * wx * wy
    )
    return out


class RangeSampler:
    """Sample without replacement from [0, num_elems) (`vidloader.py:15-45`)."""

    def __init__(self, num_elems: int, rng: np.random.Generator):
        self.num_elems = num_elems
        self.rng = rng
        self._queue = self.rng.permutation(num_elems)
        self._idx = 0

    def sample(self, num_samples: int) -> np.ndarray:
        if self._idx + num_samples > self.num_elems:
            self._queue = self.rng.permutation(self.num_elems)
            self._idx = 0
        out = self._queue[self._idx : self._idx + num_samples]
        self._idx += num_samples
        return out


class VidDataset:
    """Frame data and annotations for one video."""

    def __init__(
        self,
        rgb_path: str,
        dataid: int,
        ks: List[float],
        raw_size: List[int],
        rng: np.random.Generator,
        data_prefix: str = "crop-256",
        feature_type: str = "dinov2",
        pixels_per_image: int = -1,
    ):
        self.dataid = dataid
        self.pixels_per_image = pixels_per_image
        self.ks = ks
        self.raw_size = raw_size
        self.rng = rng

        base = os.path.join(rgb_path, f"{data_prefix}.npy")
        mask_path = base.replace("JPEGImages", "Annotations")
        cam_dir = base.replace("JPEGImages", "Cameras").rsplit("/", 1)[0]
        self.paths = {
            "rgb": base,
            "mask": mask_path,
            "depth": base.replace("JPEGImages", "Depth"),
            "feature": os.path.join(
                os.path.dirname(base.replace("JPEGImages", "Features")),
                f"{data_prefix}-{feature_type}-01.npy",
            ),
            "crop2raw": mask_path.replace(".npy", "-crop2raw.npy"),
            "is_detected": mask_path.replace(".npy", "-is_detected.npy"),
            "cambg": os.path.join(cam_dir, "00.npy"),
            "camfg": os.path.join(cam_dir, "01-canonical.npy"),
        }

        self.mmap: Dict[str, np.ndarray] = {}
        self.mmap["rgb"] = np.load(self.paths["rgb"], mmap_mode="r")
        self.num_frames = self.mmap["rgb"].shape[0]
        self.img_size = self.mmap["rgb"].shape[1:3]
        self.mmap["mask"] = np.load(self.paths["mask"], mmap_mode="r")
        self.mmap["depth"] = np.load(self.paths["depth"], mmap_mode="r")
        if os.path.exists(self.paths["feature"]):
            self.mmap["feature"] = np.load(self.paths["feature"], mmap_mode="r")
        else:
            self.mmap["feature"] = np.zeros(
                (self.num_frames, 112, 112, 16), np.float16
            )
        self.crop2raw = np.load(self.paths["crop2raw"]).astype(np.float32)
        self.is_detected = np.load(self.paths["is_detected"]).astype(np.float32)

        self.flow = {"fw": {}, "bw": {}}
        for delta in (1,) + DELTAS:
            for dname, key in (("FlowFW", "fw"), ("FlowBW", "bw")):
                p = base.replace("JPEGImages", f"{dname}_{delta}")
                if os.path.exists(p):
                    self.flow[key][delta] = np.load(p, mmap_mode="r")

        # built (and drawn from the shared rng) even for whole images, as
        # in JAX, so that the pair draws that follow stay the same
        self.idx_sampler = RangeSampler(
            self.img_size[0] * self.img_size[1], rng=self.rng
        )

    def __len__(self):
        return self.num_frames - 1

    def sample_delta(self, index: int) -> int:
        """(`vidloader.py:179-195`)."""
        deltas = [1] + [
            d
            for d in DELTAS
            if (index % d == 0) and (index + d) < self.num_frames and d in self.flow["fw"]
        ]
        return int(self.rng.choice(deltas))

    def sample_xy(self) -> Optional[np.ndarray]:
        """(pixels_per_image, 2) integer (x, y), or None for whole images
        (`vidloader.py:148`)."""
        if self.pixels_per_image == -1:
            return None
        idx = self.idx_sampler.sample(self.pixels_per_image)
        return np.stack([idx // self.img_size[0], idx % self.img_size[0]], axis=-1)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        delta = self.sample_delta(index)
        d0 = self.read_raw(index, delta, self.sample_xy())
        d1 = self.read_raw(index + delta, -delta, self.sample_xy())
        return {k: np.stack([d0[k], d1[k]]) for k in d0}

    def whole_hxy(self) -> np.ndarray:
        """(H * W, 3) integer (x, y, 1) of every pixel in raster order."""
        x0, y0 = np.meshgrid(range(self.img_size[1]), range(self.img_size[0]))
        return np.stack([x0, y0, np.ones_like(x0)], -1).reshape(-1, 3)

    def sample_feature(self, idx: int, hxy: np.ndarray) -> np.ndarray:
        """Frame ``idx``'s feature map bilinearly sampled (in float64) at
        the pixels ``hxy``, as float32."""
        feat = np.asarray(self.mmap["feature"][idx], np.float32)
        return bilinear_interp(feat, hxy[:, :2] / self.img_size[0] * feat.shape[0]
                               ).astype(np.float32)

    @span("data.read")
    def read_raw(self, idx: int, delta: int,
                 rand_xy: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Frame ``idx`` and its flow towards ``idx + delta``: every pixel in
        raster order, or the pixels ``rand_xy`` (N, 2) gathered straight from
        the memory maps (`vidloader.py:159`)."""
        COUNTS["maps"] += 1
        if rand_xy is None:
            hxy = self.whole_hxy()
            sel = lambda a: np.asarray(a, np.float32).reshape((-1,) + a.shape[2:])
        else:
            hxy = np.concatenate([rand_xy, np.ones_like(rand_xy[:, :1])], -1)
            sel = lambda a: np.asarray(a[rand_xy[:, 1], rand_xy[:, 0]], np.float32)
        feat_sel = self.sample_feature(idx, hxy)
        flow = sel(self._read_flow(idx, delta))
        rgb = sel(self.mmap["rgb"][idx])
        if rgb.ndim == 1:
            rgb = np.repeat(rgb[..., None], 3, -1)
        mask_all = sel(self.mmap["mask"][idx])
        return {
            "rgb": rgb,
            "mask": mask_all[..., :1],
            "vis2d": mask_all[..., 1:2],
            "depth": sel(self.mmap["depth"][idx])[..., None],
            "flow": flow[..., :2],
            "flow_uct": flow[..., 2:3],
            "feature": feat_sel,
            "crop2raw": self.crop2raw[idx],
            "is_detected": np.float32(self.is_detected[idx]),
            "dataid": np.int32(self.dataid),
            "frameid_sub": np.int32(idx),
            "hxy": hxy.astype(np.float32),
        }

    @staticmethod
    def flow_row(idx: int, delta: int) -> Tuple[str, int, int]:
        """The flow table (``"fw"`` or ``"bw"``, |delta|) and its row that
        hold frame ``idx``'s flow towards ``idx + delta``."""
        d = abs(delta)
        return ("fw", d, idx // d) if delta > 0 else ("bw", d, idx // d - 1)

    def _read_flow(self, idx: int, delta: int) -> np.ndarray:
        """The (H, W, 3) flow map (a memory-map view) towards idx + delta;
        zeros where the database has no such table."""
        way, d, row = self.flow_row(idx, delta)
        if d not in self.flow[way]:
            return np.zeros(self.img_size + (3,), np.float32)
        return self.flow[way][d][row]


def load_sequence_config(config_path: str):
    """Parse the database/configs/<seq>.config ini (`write_config.py:11-45`)."""
    config = configparser.RawConfigParser()
    config.read(config_path)
    data_section = dict(config["data"]) if "data" in config else {}
    vids = []
    for name in config.sections():
        if not name.startswith("data_"):
            continue
        sec = dict(config[name])
        sec = {**data_section, **sec}
        vids.append(
            {
                "img_path": sec["img_path"],
                "ks": [float(x) for x in sec["ks"].split(" ")],
                "shape": [int(x) for x in sec["shape"].split(" ")],
            }
        )
    return vids
