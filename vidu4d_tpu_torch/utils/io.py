"""Writing rendered frames (`vidu4d_tpu/utils/io.py`): every output as
``.npy``, and videos of the image-shaped ones through imageio when it is
installed. Without imageio the videos are skipped, with one printed line,
as `utils/logging.py` treats tensorboardX."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)


def save_vid(path_prefix: str, frames: List[np.ndarray], fps: int = 10) -> str:
    """Save (H, W, 3) frames in [0, 1] as ``<path_prefix>.mp4``, or as a
    ``.gif`` when imageio has no mp4 writer (`io.py:15`). Needs imageio.
    Returns the path written."""
    import imageio

    frames8 = [to_uint8(f) for f in frames]
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    try:
        imageio.mimsave(f"{path_prefix}.mp4", frames8, fps=fps)
        return f"{path_prefix}.mp4"
    except (ImportError, ValueError, RuntimeError):
        # no ffmpeg backend: pillow's gif writer, per-frame duration in ms
        imageio.mimsave(f"{path_prefix}.gif", frames8, duration=int(1000 / max(fps, 1)))
        return f"{path_prefix}.gif"


def save_rendered(rendered: Dict[str, np.ndarray], save_dir: str, fps: int = 10) -> None:
    """Each rendered output as ``<key>.npy``, and (M, H, W, 1 or 3) ones as
    a video too when imageio is installed (`io.py:31`); one-channel outputs
    are scaled by their maximum."""
    os.makedirs(save_dir, exist_ok=True)
    try:
        import imageio  # noqa: F401
        videos = True
    except ImportError:
        videos = False
        print(f"imageio is not installed: {save_dir} gets .npy files only, no videos")
    for key, value in rendered.items():
        value = np.asarray(value)
        np.save(os.path.join(save_dir, f"{key}.npy"), value)
        if videos and value.ndim == 4 and value.shape[-1] in (1, 3):
            if value.shape[-1] == 1:
                v = value[..., 0]
                vmax = max(v.max(), 1e-6)
                frames = [np.stack([f / vmax] * 3, -1) for f in v]
            else:
                frames = list(value)
            save_vid(os.path.join(save_dir, key), frames, fps=fps)
