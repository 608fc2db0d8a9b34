"""Mesh I/O and surface sampling on numpy (the host-side part of
`vidu4d_tpu/ops/marching.py`): the Stage-2 mesh the surfels start from, and
the per-frame OBJ sequence of the export. Marching tetrahedra (Stage 2)
is not ported yet."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Minimal OBJ writer (`marching.py:177`): ``v x y z [r g b]`` lines,
    then 1-based ``f`` lines."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def load_obj(path: str):
    """Minimal OBJ reader (`marching.py:194`): (verts (V, 3) float32,
    faces (F, 3) int32, 0-based)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(p.split("/")[0]) - 1 for p in line.split()[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        rng: np.random.Generator):
    """Uniform area-weighted surface sampling (`marching.py:208`), the same
    draws from ``rng`` as the JAX package. Returns (points (n, 3) float32,
    face ids (n,), barycentric weights (n, 3) float32)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    probs = areas / areas.sum()
    fid = rng.choice(len(faces), size=n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    w = 1 - u - v
    pts = w * verts[faces[fid, 0]] + u * verts[faces[fid, 1]] + v * verts[faces[fid, 2]]
    bary = np.concatenate([w, u, v], axis=-1)
    return pts.astype(np.float32), fid, bary.astype(np.float32)
