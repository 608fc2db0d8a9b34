"""Isosurface extraction by marching tetrahedra, mesh I/O and surface
sampling (`vidu4d_tpu/ops/marching.py`).

`marching_tets` runs on tensors on any device: each grid cube is split
into 6 tetrahedra and each tetrahedron emits up to 2 triangles into a
fixed-capacity soup with a validity mask, as in JAX. `extract_mesh_np`
compacts the soup with the mask on the device, copies only the real
triangles to the host and welds them there (`weld_vertices`, numpy). The
OBJ reader / writer and the area-weighted sampling (the Stage-2 mesh the
surfels start from, the export's OBJ sequence) are numpy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# 6-tetrahedra decomposition of a cube (corner ids = binary x + 2y + 4z)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 3, 6], [0, 3, 2, 6], [0, 2, 4, 6], [0, 4, 5, 6], [3, 1, 5, 6]],
    dtype=np.int64,
)
# (dx, dy, dz) offsets of corner ids 0..7
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int64,
)
# the 6 edges of a tetrahedron (vertex pairs)
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)
# the 3 edges incident to each vertex, in `_EDGES` order
_VERT_EDGES = np.array([[0, 1, 2], [0, 3, 4], [1, 3, 5], [2, 4, 5]], dtype=np.int64)
# the quad's edges in strip order for each inside pair (0,1) (0,2) (0,3)
# (1,2) (1,3) (2,3)
_PAIR_TABLE = np.array(
    [[1, 2, 3, 4], [0, 2, 3, 5], [0, 1, 4, 5], [0, 4, 1, 5], [0, 3, 2, 5], [1, 3, 2, 4]],
    dtype=np.int64,
)


@torch.no_grad()
def marching_tets(sdf_grid: torch.Tensor, aabb: torch.Tensor, level: float = 0.0):
    """The ``level`` isosurface of a dense SDF (`marching.py:44`).

    sdf_grid (G, G, G), index order [x, y, z], spanning aabb (2, 3)
    uniformly. Returns (tri_verts (T, 3, 3) triangle-soup positions,
    tri_valid (T,) bool) with T = 12 (G - 1)^3: the single-vertex
    triangle or the quad's first triangle of every tetrahedron, then the
    quad's second triangles."""
    dev = sdf_grid.device
    n = sdf_grid.shape[0] - 1
    sdf = sdf_grid - level
    ar = torch.arange(n, device=dev)
    cells = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    corners = cells[:, None, :] + torch.as_tensor(_CORNERS, device=dev)[None]  # (C, 8, 3)
    corner_sdf = sdf[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)
    spacing = (aabb[1] - aabb[0]) / n
    corner_pos = aabb[0] + corners.to(sdf.dtype) * spacing  # (C, 8, 3)
    del corners

    tets = torch.as_tensor(_TETS, device=dev)
    tet_sdf = corner_sdf[:, tets].reshape(-1, 4)  # (C6, 4)
    tet_pos = corner_pos[:, tets].reshape(-1, 4, 3)  # (C6, 4, 3)
    del corner_sdf, corner_pos
    inside = tet_sdf < 0
    n_inside = torch.sum(inside.to(torch.int32), dim=-1)

    edges = torch.as_tensor(_EDGES, device=dev)
    s0, s1 = tet_sdf[:, edges[:, 0]], tet_sdf[:, edges[:, 1]]
    denom = s0 - s1
    t = torch.clamp(s0 / torch.where(torch.abs(denom) < 1e-12, 1.0, denom), 0.0, 1.0)
    p0, p1 = tet_pos[:, edges[:, 0]], tet_pos[:, edges[:, 1]]
    edge_pts = p0 + t[..., None] * (p1 - p0)  # (C6, 6, 3)
    del tet_pos, p0, p1, t

    # the lone vertex: the inside one of 1 inside, the outside one of 3
    ins8 = inside.to(torch.int8)
    lone = torch.where(n_inside == 1, torch.argmax(ins8, dim=-1), torch.argmax(1 - ins8, dim=-1))
    tri1_edges = torch.as_tensor(_VERT_EDGES, device=dev)[lone]  # (C6, 3)
    i0, i1, i2, i3 = inside.unbind(-1)
    pid = ((i0 & i2).long() * 1 + (i0 & i3).long() * 2 + (i1 & i2).long() * 3
           + (i1 & i3).long() * 4 + (i2 & i3).long() * 5)
    # 3 or 4 inside sum past the table; JAX's gather clamps the index (the
    # rows are invalid, but their soup values are kept alike)
    pid = torch.clamp(pid, max=len(_PAIR_TABLE) - 1)
    quad = torch.as_tensor(_PAIR_TABLE, device=dev)[pid]  # (C6, 4)
    is1or3 = (n_inside == 1) | (n_inside == 3)
    is2 = n_inside == 2

    def tri(idx):
        return torch.gather(edge_pts, 1, idx[..., None].expand(-1, -1, 3))

    tri_a = tri(torch.where(is1or3[:, None], tri1_edges, quad[:, :3]))
    tri_b = tri(quad[:, 1:])
    return torch.cat([tri_a, tri_b]), torch.cat([is1or3 | is2, is2])


def extract_mesh_np(sdf_grid: torch.Tensor, aabb, level: float = 0.0):
    """Compact welded mesh (verts (V, 3) float32, faces (F, 3) int32) as
    numpy (`marching.py:152`): the soup is compacted with its mask on the
    grid's device before the copy to the host."""
    aabb = torch.as_tensor(aabb, dtype=sdf_grid.dtype, device=sdf_grid.device)
    tri_verts, tri_valid = marching_tets(sdf_grid, aabb, level=level)
    return weld_vertices(tri_verts[tri_valid].cpu().numpy())


def weld_vertices(tri_soup: np.ndarray, decimals: int = 6):
    """Merge duplicate vertices of a (T, 3, 3) triangle soup on the host
    (`marching.py:161`): vertices equal after rounding to ``decimals`` are
    one; degenerate faces are dropped."""
    if len(tri_soup) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = tri_soup.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return uniq.astype(np.float32), faces[good]


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
