"""Binary PLY import/export of the surfel store
(`vidu4d_tpu/models/gaussian/ply_io.py`), on numpy.

The canonical 3DGS schema: little-endian float32 vertex properties
x, y, z, nx, ny, nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*, with the SH
coefficients flattened channel-major. The bytes equal the JAX package's
for the same arrays.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams


def _attribute_names(n_rest: int, n_scale: int = 2) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(n_scale)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(path: str, params: SurfelParams, alive: Optional[np.ndarray] = None) -> None:
    """Write the alive surfels of ``params`` (numpy arrays) in the 3DGS
    layout (raw / log-space values)."""
    xyz = np.asarray(params.xyz, dtype=np.float32)
    keep = np.ones(xyz.shape[0], dtype=bool) if alive is None else np.asarray(alive)
    xyz = xyz[keep]
    n = xyz.shape[0]
    # (N, K, 3) -> channel-major (N, 3 K); explicit widths, so that a store
    # with no alive surfel gives an empty file (reshape(0, -1) raises)
    f_dc = np.asarray(params.features_dc, np.float32)[keep].transpose(0, 2, 1).reshape(n, 3)
    f_rest = np.asarray(params.features_rest, np.float32)[keep]
    n_rest = f_rest.shape[1]
    f_rest = f_rest.transpose(0, 2, 1).reshape(n, 3 * n_rest)
    opac = np.asarray(params.opacity, np.float32)[keep].reshape(n, 1)
    scale = np.asarray(params.scaling, np.float32)[keep]
    rot = np.asarray(params.rotation, np.float32)[keep]

    attrs = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, opac, scale, rot], axis=1)
    names = _attribute_names(n_rest, n_scale=scale.shape[1])
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(attrs.astype("<f4").tobytes())


def load_ply(path: str) -> Tuple[SurfelParams, int]:
    """Read a 3DGS-schema ply: (SurfelParams of numpy arrays, count)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    n, names = None, []
    for line in data[:head_end].decode("ascii").splitlines():
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property float"):
            names.append(line.split()[-1])
    if n is None:
        raise ValueError(f"{path}: not a vertex ply")
    rec = np.frombuffer(data[head_end:], dtype=np.dtype([(nm, "<f4") for nm in names]),
                        count=n)

    def cols(prefix, count):
        return np.stack([rec[f"{prefix}_{i}"] for i in range(count)], axis=1)

    n_rest3 = sum(1 for nm in names if nm.startswith("f_rest_"))
    n_rest = n_rest3 // 3
    f_rest = (cols("f_rest", n_rest3).reshape(n, 3, n_rest).transpose(0, 2, 1) if n_rest
              else np.zeros((n, 0, 3), np.float32))
    n_scale = sum(1 for nm in names if nm.startswith("scale_"))
    params = SurfelParams(
        xyz=np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32),
        features_dc=np.ascontiguousarray(
            cols("f_dc", 3).reshape(n, 3, 1).transpose(0, 2, 1), np.float32),
        features_rest=np.ascontiguousarray(f_rest, np.float32),
        scaling=cols("scale", n_scale).astype(np.float32),
        rotation=cols("rot", 4).astype(np.float32),
        opacity=rec["opacity"].reshape(n, 1).astype(np.float32),
        regist_feat=np.zeros((n, 0), np.float32),
    )
    return params, n
