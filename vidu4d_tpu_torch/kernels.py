"""Build and load the port's hand-written CUDA kernels.

The sources in ``vidu4d_tpu_torch/csrc/*.cu`` have a plain C interface. On
first use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one
process per source, all at once, and linked into one shared library under ``vidu4d_tpu_torch/_build/`` (named by a hash of the
sources, so an edited source is never served from a stale build) and loaded
with ``ctypes``. Nothing is compiled or loaded at import time.

Each kernel wrapper counts its launches in ``COUNTS`` (and each plain
PyTorch version its calls), so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # no FMA contraction: the affine intersection p = A + px*B + py*C
    # cancels large terms, so the kernels round it as the plain versions
    # (separate multiply and add) do
    "-fmad=false",
]

# launches of each kernel (incremented by its wrapper right after a
# successful launch) and calls of each plain PyTorch version
COUNTS = {
    "tile_forward": 0,
    "tile_backward": 0,
    "tile_forward_plain": 0,
    "tile_backward_plain": 0,
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from vidu4d_tpu_torch/csrc at first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile the kernels (once per process; reuses an up-to-date build).

    Returns {"path", "seconds", "cached", "ptxas"}: the library path, the
    build time, whether an existing build was reused, and nvcc's ptxas
    report (registers / shared memory / spills per kernel)."""
    cu, cuh = _sources()
    digest = hashlib.sha256()
    for f in cu + cuh:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libvidu4d_kernels_{tag}.so"
    log = BUILD_DIR / f"libvidu4d_kernels_{tag}.log"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "cached": True,
                "ptxas": log.read_text() if log.exists() else ""}
    nvcc = _find_nvcc()
    stem = BUILD_DIR / f".{lib.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs = [Path(f"{stem}.{f.stem}.o") for f in cu]
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                                str(f)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True), f)
             for f, o in zip(cu, objs)]
    report = []
    for proc, f in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {f.name} ({proc.returncode}):\n{err}")
        report.append(err)
    tmp = Path(f"{stem}.so")
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)
    log.write_text("".join(report))
    return {"path": str(lib), "seconds": seconds, "cached": False,
            "ptxas": "".join(report)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vidu4d_tile_forward.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.vidu4d_tile_forward.restype = i
    lib.vidu4d_tile_backward.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.vidu4d_tile_backward.restype = i
    for layout in (lib.vidu4d_tile_seg, lib.vidu4d_tile_part_fixed):
        layout.argtypes = []
        layout.restype = i
    lib.vidu4d_error_string.argtypes = [i]
    lib.vidu4d_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a launch error."""
    if rc != 0:
        msg = library().vidu4d_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, device, shape=None,
                 dtype=torch.float32) -> None:
    """Wrapper-side argument checks: device, dtype, contiguity, shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
