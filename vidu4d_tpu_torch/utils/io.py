"""Image and frame I/O (`vidu4d_tpu/utils/io.py`).

Rendered frames: every output as ``.npy``, and videos of the image-shaped
ones through imageio when it is installed. Without imageio the videos are
skipped, with one printed line, as `utils/logging.py` treats tensorboardX.

Images: `read_image` reads through imageio when it can be imported; without
it, it decodes 8-bit grey / RGB / RGBA non-interlaced PNGs itself (zlib +
struct, all five row filters) and raises for anything else. `write_png`
writes such PNGs on the standard library.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes (uint8) from its filtered bytes and the
    reconstructed row above (zeros for the first)."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: a running sum per channel, mod 256
        return (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64) % 256
                ).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
    # Average and Paeth depend on the reconstructed left neighbour
    out, up = bytearray(row.tobytes()), prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (a + up[i]) >> 1
        else:
            pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _decode_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: imageio is not installed and the file is not a PNG")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit grey / RGB / RGBA non-interlaced PNGs are "
                         f"read without imageio (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = img[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    return img.reshape(h, w, bpp)[..., 0] if bpp == 1 else img.reshape(h, w, bpp)


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` as a uint8 array (H, W) or (H, W, C): through
    imageio when it is installed, else by the PNG decoder above, which
    raises (naming the file) for anything but an 8-bit grey / RGB / RGBA
    non-interlaced PNG."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        return _decode_png(path)
    return np.asarray(imageio.imread(path))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as an
    8-bit non-interlaced PNG (every row with filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    channels = 1 if img.ndim == 2 else img.shape[-1]
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if ctype is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * channels)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def savez_atomic(path: str, arrays: Dict[str, np.ndarray], compressed: bool = False) -> str:
    """``np.savez`` (or ``np.savez_compressed``) of ``arrays`` to ``path``
    (".npz" appended when missing, as numpy does) through a temporary file
    in the same directory that is then moved into place: a run killed
    while writing leaves the old file or none, never a truncated one. The
    bytes are numpy's. Returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".{os.path.basename(path)}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            (np.savez_compressed if compressed else np.savez)(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
