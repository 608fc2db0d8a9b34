"""ctypes bindings for the native batch sampler (`vidu4d_tpu/data/native.py`).

The host gather of the sampled-pixel reads, `csrc/batch_sampler.cpp` at
the repository's root (the JAX package's source, used as it is). It is
compiled on first use with g++ into ``vidu4d_tpu_torch/_build/`` (named by
a hash of the source; written under a per-process name and moved into
place, so concurrent processes never load a half-written library). Callers
fall back to numpy gathers when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "batch_sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def load_library():
    """Compile (once) and load the shared library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
            so = BUILD_DIR / f"libbatch_sampler_{tag}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                                str(SOURCE), "-o", str(tmp)], check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            for name in ("gather_pixels_f16", "gather_pixels_f32"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int,
                ]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _LIB = None
        return _LIB


def gather_pixels(src: np.ndarray, frame_ids: np.ndarray, xy: np.ndarray,
                  n_threads: int = 8) -> np.ndarray:
    """Gather pixels: src (T, H, W, C) f16/f32; frame_ids (n,); xy (n, p, 2)
    int32 (x, y). Returns (n, p, C) float32. Numpy fallback when the native
    library is unavailable."""
    if src.ndim == 3:
        src = src[..., None]
    t, h, w, c = src.shape
    n, p, _ = xy.shape
    if n * p * c < (1 << 17):
        n_threads = 1  # thread spawn would dominate on small gathers
    lib = load_library()
    if lib is not None and src.flags.c_contiguous and src.dtype in (
        np.float16, np.float32
    ):
        out = np.empty((n, p, c), np.float32)
        frame_ids = np.ascontiguousarray(frame_ids, np.int32)
        xy = np.ascontiguousarray(xy, np.int32)
        fn = (lib.gather_pixels_f16 if src.dtype == np.float16
              else lib.gather_pixels_f32)
        fn(src.ctypes.data, t, h, w, c, frame_ids.ctypes.data, xy.ctypes.data,
           n, p, out.ctypes.data, n_threads)
        return out
    # numpy fallback
    out = src[frame_ids[:, None], xy[..., 1], xy[..., 0]]
    return np.asarray(out, np.float32)
