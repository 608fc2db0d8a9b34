"""The port's mesh extraction against the JAX package's, on the CPU:
`bilinear_sample`, TSDF fusion, marching tetrahedra, the weld and
`extract_mesh` from trained-looking surfels.

Tolerances:
* `bilinear_sample` 1e-6 (the same float32 formulas), including the
  border clamp that rounds w - 1.000001 to w - 1 for w >= 256;
* `fuse_tsdf`: the weight exactly, tsdf and colour to 2e-5 (voxel centres
  come from `linspace`s that differ by an ulp, and the camera inverses from
  other LAPACK calls), except at voxels whose test lies within rounding of
  a boundary (the plane's grid puts some exactly on a frustum side), which
  are listed in float64 and left out (< 1% of the grid);
* `marching_tets`: the validity mask exactly, the soup to 1e-6 (JAX's
  compiler contracts p0 + t (p1 - p0) into fused multiply-adds; measured
  1.2e-7);
* `weld_vertices`: equal on one soup;
* `extract_mesh` end to end: the rendered alpha as `rasterize` (a pixel
  where a splat crosses the 1/255 alpha cut in one package only is left
  out); the welded meshes by symmetric Chamfer distance (mean
  nearest-vertex distance both ways) <= 1e-4 of the diagonal of the fusion
  volume's box, and vertex counts within 1%: the 6-decimal weld can round
  the two soups' ulp-apart vertices apart, and a voxel whose test sits on
  a boundary can move the surface by a voxel (measured: 6.3e-4 on a
  diagonal of 16.1, 3.9e-5 of it).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, look_at, n, rot_to_qvec, t
from vidu4d_tpu.models.gaussian import extract as jext
from vidu4d_tpu.models.gaussian import surfels as jsf
from vidu4d_tpu.ops import marching as jm
from vidu4d_tpu.preprocess import ops as jops
from vidu4d_tpu.preprocess import tsdf as jtsdf
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.models.gaussian import extract as text
from vidu4d_tpu_torch.ops import marching as tm
from vidu4d_tpu_torch.ops.rasterize.common import ALPHA_EPS
from vidu4d_tpu_torch.preprocess import ops as tops
from vidu4d_tpu_torch.preprocess import tsdf as ttsdf


@pytest.mark.parametrize("w", [37, 1237])
def test_bilinear_sample_matches_jax(w):
    """Queries inside, on and beyond every border; at w = 1237 the clamp
    leaves x0 + 1 == w, which JAX's gather clamps and the port's index
    clamp reproduces."""
    rng = np.random.default_rng(w)
    h = 29
    img = rng.normal(size=(h, w, 3)).astype(np.float32)
    x = np.concatenate([rng.uniform(-5, w + 5, 400), [0, w - 1, w - 1.5, w, 2 * w]])
    y = np.concatenate([rng.uniform(-5, h + 5, 400), [0, h - 1, h - 0.5, h, -1]])
    x, y = x.astype(np.float32), y.astype(np.float32)
    ref = jops.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    got = tops.bilinear_sample(t(img), t(x), t(y))
    assert_close(ref, got, 1e-6, 1e-6, "bilinear_sample")
    if w >= 256:
        assert np.float32(w - 1.000001) == w - 1


def test_fuse_tsdf_matches_jax():
    """tests/test_preprocess.py's fronto-parallel plane at z = 2, at 256 x
    256 (the border clamp trap fires for voxels projecting past the right
    and bottom edges), from two cameras."""
    h = w = 256
    fx = 256.0
    kinv = np.linalg.inv(np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32))
    depth = np.full((2, h, w), 2.0, np.float32)
    depth[1, :, :40] = 0.0  # an unobserved strip
    colors = np.random.default_rng(0).uniform(size=(2, h, w, 3)).astype(np.float32)
    cam2scene = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    cam2scene[1, :3, 3] = [0.1, -0.05, 0.0]
    kinvs = np.stack([kinv, kinv])
    vol_bnds = np.array([[-1.5, -1.5, 0.5], [1.5, 1.5, 3.0]], np.float32)
    ref = jtsdf.fuse_tsdf(*map(jnp.asarray, (depth, colors, kinvs, cam2scene, vol_bnds)),
                          grid_size=48)
    got = ttsdf.fuse_tsdf(*map(t, (depth, colors, kinvs, cam2scene, vol_bnds)), grid_size=48)
    # voxels whose test lies on a boundary within rounding: the grid puts
    # some exactly on a frustum side (x / z = -0.5), the strip's edge or
    # the truncation distance, where an ulp decides
    amb = _boundary_voxels(kinvs, cam2scene, vol_bnds, 48, h, w, edges_u=[[], [39.0]])
    assert amb.mean() < 0.01, amb.mean()
    np.testing.assert_array_equal(n(ref[2])[~amb], n(got[2])[~amb])
    assert float(got[2].max()) == 2.0 and float(got[2].min()) == 0.0
    assert_close(n(ref[0])[~amb], n(got[0])[~amb], 2e-5, 0.0, "tsdf")
    assert_close(n(ref[1])[~amb], n(got[1])[~amb], 1e-4, 0.0, "color")
    verts, faces = ttsdf.tsdf_to_mesh(got[0], got[2], t(vol_bnds))
    jverts, jfaces = jtsdf.tsdf_to_mesh(np.asarray(ref[0]), np.asarray(ref[2]), vol_bnds)
    assert len(verts) > 0 and abs(len(verts) - len(jverts)) <= 0.01 * len(jverts)
    assert (np.abs(verts[:, 2] - 2.0) < 0.1).mean() > 0.3 and verts[:, 2].min() > 1.7

    frustum = ttsdf.view_frustum_points(t(depth[0]), t(kinv), t(cam2scene[1]))
    assert_close(jtsdf.view_frustum_points(jnp.asarray(depth[0]), jnp.asarray(kinv),
                                           jnp.asarray(cam2scene[1])), frustum, 1e-6, 1e-6,
                 "frustum")
    s2c = np.linalg.inv(cam2scene)
    for a, b in zip(jtsdf.recenter_mesh_and_cams(jverts, s2c),
                    ttsdf.recenter_mesh_and_cams(jverts, s2c)):
        np.testing.assert_array_equal(a, b)


def _boundary_voxels(kinvs, cam2scene, vol_bnds, g, h, w, edges_u, depth=2.0, tol=1e-3):
    """(G, G, G) bool: voxels whose projection in some frame lies within
    ``tol`` px of the image's valid range or of a column in ``edges_u``
    (per frame), or whose plane distance lies within 1e-5 of -trunc
    (float64)."""
    axes = [np.linspace(vol_bnds[0, i], vol_bnds[1, i], g) for i in range(3)]
    vox = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    trunc = 5.0 * np.max((vol_bnds[1] - vol_bnds[0]) / g)
    amb = np.zeros(len(vox), bool)
    for kinv, c2s, cols in zip(kinvs, cam2scene, edges_u):
        s2c = np.linalg.inv(c2s.astype(np.float64))
        cam = vox @ s2c[:3, :3].T + s2c[:3, 3]
        k = np.linalg.inv(kinv.astype(np.float64))
        u = k[0, 0] * cam[:, 0] / cam[:, 2] + k[0, 2]
        v = k[1, 1] * cam[:, 1] / cam[:, 2] + k[1, 2]
        for x, lines in ((u, [0.0, w - 1.0] + list(cols)), (v, [0.0, h - 1.0])):
            for line in lines:
                amb |= np.abs(x - line) < tol
        amb |= np.abs(depth - cam[:, 2] + trunc) < 1e-5
    return amb.reshape(g, g, g)


def _sdf_grid(g, seed):
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1, 1, g)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2) - 0.6
            + 0.05 * rng.normal(size=x.shape)).astype(np.float32)


def test_marching_tets_and_weld_match_jax():
    """A noisy ellipsoid SDF at G = 24 (every sign case occurs): the soup
    and its mask, then the weld of one soup in both packages, and the
    port's extract_mesh_np."""
    sdf = _sdf_grid(24, 0)
    aabb = np.array([[-1, -1, -1], [1, 1, 1.2]], np.float32)
    jv, jmask = jm.marching_tets(jnp.asarray(sdf), jnp.asarray(aabb))
    tv, tmask = tm.marching_tets(t(sdf), t(aabb))
    assert tv.shape == (12 * 23 ** 3, 3, 3)
    np.testing.assert_array_equal(n(jmask), n(tmask))
    assert_close(jv, tv, 1e-6, 0.0, "soup")
    soup = np.asarray(jv)[np.asarray(jmask)]
    for a, b in zip(jm.weld_vertices(soup), tm.weld_vertices(soup)):
        np.testing.assert_array_equal(a, b)
    verts, faces = tm.extract_mesh_np(t(sdf), aabb)
    assert faces.max() < len(verts) and len(faces) > 1000
    for a, b in zip(jm.weld_vertices(soup[:0]), tm.weld_vertices(soup[:0])):
        np.testing.assert_array_equal(a, b)


class _Cam(NamedTuple):
    viewmat: np.ndarray
    intrins: np.ndarray


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean()


def test_extract_mesh_matches_jax(tmp_path):
    """600 opaque surfels tangent to an ellipsoid shell, 8 cameras on a
    ring at 64 x 48, grid 40: the JAX tiles path vs the port's kernels'
    plain versions, end to end (render, fuse, march, weld, OBJ)."""
    rng = np.random.default_rng(5)
    p, h, w = 600, 48, 64
    axes = np.array([0.9, 0.6, 0.8])
    u = rng.normal(size=(p, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pts = (u * axes).astype(np.float32)
    normal = pts / axes ** 2
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    tangent = np.cross(normal, rng.normal(size=(p, 3)))
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    quats = rot_to_qvec(np.stack([tangent, np.cross(normal, tangent), normal], -1))
    state = jsf.init_from_points(jnp.asarray(pts), jnp.asarray(rng.uniform(size=(p, 3))),
                                 p + 40, sh_degree=3)
    params = state.params._replace(
        rotation=jnp.asarray(np.concatenate([quats, np.tile([1.0, 0, 0, 0], (40, 1))]),
                             jnp.float32),
        scaling=jnp.full_like(state.params.scaling, np.log(0.09)),
        opacity=jnp.full_like(state.params.opacity, 3.0))
    cams = [_Cam(look_at(2.6 * np.array([np.sin(a), -0.3, np.cos(a)])),
                 np.array([60.0, 60.0, w / 2, h / 2], np.float32))
            for a in np.linspace(0, 2 * np.pi, 9)[:-1]]
    jverts, jfaces = jext.extract_mesh(params, state.alive, cams, h, w, grid_size=40)
    ts = convert.surfel_state_from_jax(
        {"params": {f: np.asarray(getattr(params, f)) for f in params._fields},
         "alive": np.asarray(state.alive), "max_radii2d": np.zeros(p + 40),
         "grad_accum": np.zeros(p + 40), "denom": np.zeros(p + 40)}, "cpu")
    depths, alphas = text.render_depth_maps(ts.params, ts.alive, cams, h, w)
    jdepths, jalphas = jext.render_depth_maps(params, state.alive, cams, h, w)
    # a splat's alpha can cross the 1/255 cut at a pixel in one package
    # only (tests/test_torch_gs_static.py): such pixels differ by at most
    # 1/255 in alpha and are left out
    d_alpha = np.abs(n(alphas) - n(jalphas))
    flips = d_alpha > 5e-4
    assert flips.mean() < 1e-3 and np.all(d_alpha[flips] <= ALPHA_EPS * (1 + 1e-3))
    assert_close(n(jalphas)[~flips], n(alphas)[~flips], 5e-4, 1e-3, "alpha")
    assert float((alphas > 0.5).float().mean()) > 0.2
    obj = str(tmp_path / "fused_mesh.obj")
    tverts, tfaces = text.extract_mesh(ts.params, ts.alive, cams, h, w, grid_size=40,
                                       out_path=obj)
    v_obj, f_obj = tm.load_obj(obj)
    np.testing.assert_array_equal(f_obj, tfaces)
    assert_close(tverts, v_obj, 1e-6, 1e-6, "obj vertices")
    assert len(tfaces) > 500 and abs(len(tverts) - len(jverts)) <= 0.01 * len(jverts)
    # the fusion volume's box, as extract_mesh sets it
    masked = np.where((n(jalphas) > 0.5) & (n(jdepths) < 10.0), n(jdepths), 0.0)
    centers = np.stack([np.linalg.inv(c.viewmat)[:3, 3] for c in cams])
    diag = float(np.linalg.norm(centers.max(0) - centers.min(0) + 2 * np.abs(masked).max()))
    chamfer = _chamfer(jverts, tverts)
    assert chamfer <= 1e-4 * diag, (chamfer, diag)
