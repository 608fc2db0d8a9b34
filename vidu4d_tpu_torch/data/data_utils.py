"""Dataset construction + metadata extraction + batching helpers
(`vidu4d_tpu/data/data_utils.py`).

Sequence config ini -> per-video VidDatasets -> dataset metadata
(`get_data_info`) -> random pair batches (`PairBatcher`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.data.vidloader import VidDataset, load_sequence_config
from vidu4d_tpu_torch.utils.host_map import host_slice, node_index


def build_datasets(opts: Dict, rng: Optional[np.random.Generator] = None,
                   process_index: Optional[int] = None) -> List[VidDataset]:
    """One VidDataset per video of the sequence config, sharing ``rng``
    (default: seeded with ``opts["seed"] + 7919 * process_index + 1``, as
    the JAX package seeds it per host, `data_utils.py:33-42`;
    ``process_index`` defaults to this node, `host_map.node_index`). Items
    hold ``opts["pixels_per_image"]`` pixels (default 16; -1 = whole
    images)."""
    if rng is None:
        host = node_index() if process_index is None else process_index
        rng = np.random.default_rng(opts.get("seed", 0) + 7919 * host + 1)
    config_path = os.path.join(
        opts.get("dataroot", "database"), "configs", f"{opts['seqname']}.config"
    )
    vids = load_sequence_config(config_path)
    prefix = f"{opts['data_prefix']}-{opts['train_res']}"
    return [
        VidDataset(
            rgb_path=vid["img_path"],
            dataid=vidid,
            ks=vid["ks"],
            raw_size=vid["shape"],
            rng=rng,
            data_prefix=prefix,
            feature_type=opts.get("feature_type", "dinov2"),
            pixels_per_image=opts.get("pixels_per_image", 16),
        )
        for vidid, vid in enumerate(vids)
    ]


def pca_fn(features: np.ndarray, n_components: int = 3):
    """Fit PCA, return an apply function (`data_utils.py` pca_numpy)."""
    mean = features.mean(axis=0)
    centered = features - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    basis = vt[:n_components]

    def apply(x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        out = (flat - mean) @ basis.T
        return out.reshape(shape[:-1] + (n_components,))

    return apply


def get_data_info(datasets: List[VidDataset]) -> Dict:
    """Dataset metadata (`data_utils.py:226-335`)."""
    if not datasets:
        raise ValueError(
            "config lists no videos — write_config skips sequences shorter "
            "than 8 frames (reference rule), so check the sequence length "
            "and that JPEGImages/Full-Resolution/<seqname>/ has .jpg frames"
        )
    frame_offset = [0]
    frame_offset_raw = [0]
    frame_mapping = []
    intrinsics = []
    raw_size = []
    feature_px = []

    for ds in datasets:
        n = ds.num_frames
        frame_offset.append(frame_offset[-1] + n)
        frame_offset_raw.append(frame_offset_raw[-1] + n)
        frame_mapping += [i + frame_offset_raw[-2] for i in range(n)]
        intrinsics += [ds.ks] * n
        raw_size.append(ds.raw_size)
        feats = np.asarray(ds.mmap["feature"], np.float32).reshape(-1, 16)
        feature_px.append(feats[:: max(1, len(feats) // 1000)])

    feature_px = np.concatenate(feature_px, 0)
    feature_px = feature_px[np.linalg.norm(feature_px, 2, -1) > 0]

    frame_info = FrameInfo(
        frame_offset=tuple(frame_offset),
        frame_mapping=tuple(frame_mapping),
        frame_offset_raw=tuple(frame_offset_raw),
    )

    data_info = {
        "frame_info": frame_info,
        "total_frames": frame_offset[-1],
        "intrinsics": np.asarray(intrinsics, np.float32),
        "raw_size": np.asarray(raw_size),
        "apply_pca_fn": pca_fn(feature_px) if len(feature_px) else None,
    }

    # camera priors + centered meshes (`data_utils.py:305-335`)
    rt_bg, rt_fg = [], []
    for ds in datasets:
        if os.path.exists(ds.paths["cambg"]):
            rt_bg.append(np.load(ds.paths["cambg"]).astype(np.float32))
        if os.path.exists(ds.paths["camfg"]):
            rt_fg.append(np.load(ds.paths["camfg"]).astype(np.float32))
    if rt_fg:
        rtmat_fg = np.concatenate(rt_fg, 0)
        rtmat_bg = np.concatenate(rt_bg, 0) if rt_bg else rtmat_fg
        data_info["rtmat"] = np.stack([rtmat_bg, rtmat_fg], 0)
        cam_dir = os.path.dirname(datasets[0].paths["cambg"])
        data_info["geom_path"] = [
            os.path.join(cam_dir, "mesh-00-centered.obj"),
            os.path.join(cam_dir, "mesh-01-centered.obj"),
        ]
    return data_info


class PairBatcher:
    """Random (video, frame) pair batches across videos (`data_utils.py:140`):
    each call returns a dict of (imgs_per_batch, 2, ...) numpy arrays, the
    same draws as JAX's for the same seed. Over several hosts each samples
    its `host_slice` of the (video, frame) index with an rng seeded with
    ``seed + host_id`` (default: this node, `host_map.node_index`)."""

    def __init__(self, datasets: List[VidDataset], imgs_per_batch: int, seed: int = 0,
                 num_hosts: Optional[int] = None, host_id: Optional[int] = None):
        self.datasets = datasets
        self.imgs_per_batch = imgs_per_batch
        index = [(vid, t) for vid, ds in enumerate(datasets) for t in range(len(ds))]
        self.index = host_slice(index, process_index=host_id, process_count=num_hosts)
        self.host_id = host_id
        self.rng = np.random.default_rng(seed + (host_id if host_id is not None
                                                 else node_index()))

    def draw(self) -> List[Tuple[int, int, int, Optional[np.ndarray], Optional[np.ndarray]]]:
        """The next batch's rng draws, each item's as `VidDataset.__getitem__`
        makes them: (video, first frame, delta, the first frame's pixels,
        the second's), the pixels None for whole images."""
        picks = self.rng.integers(0, len(self.index), size=self.imgs_per_batch)
        out = []
        for p in picks:
            vid, t = self.index[p]
            ds = self.datasets[vid]
            out.append((vid, t, ds.sample_delta(t), ds.sample_xy(), ds.sample_xy()))
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        items = []
        for vid, t, delta, xy0, xy1 in self.draw():
            ds = self.datasets[vid]
            d0, d1 = ds.read_raw(t, delta, xy0), ds.read_raw(t + delta, -delta, xy1)
            items.append({k: np.stack([d0[k], d1[k]]) for k in d0})
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def flatten_pairs(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """(M, 2, ...) -> (2M, ...) (`model.py:539-548`)."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}


def compute_frameid(batch: Dict, frame_info: FrameInfo) -> Dict:
    """Add global raw frame ids (`model.py:94-110`)."""
    offset = np.asarray(frame_info.frame_offset_raw)
    batch = dict(batch)
    batch["frameid"] = batch["frameid_sub"] + offset[batch["dataid"]]
    return batch
