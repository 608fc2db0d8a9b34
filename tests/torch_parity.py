"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each parity test makes its inputs with numpy from a seed, runs them through
the JAX reference (on the CPU, as the JAX tests run it) and through the
port, and compares the results as numpy arrays.
"""

import numpy as np
import torch

# pytest-xdist runs several workers at once: keep each one's torch CPU pool
# small so they do not oversubscribe the cores
torch.set_num_threads(2)


def t(x, requires_grad: bool = False, device="cpu") -> torch.Tensor:
    """numpy / JAX array -> a fresh float32 (or int/bool) torch tensor."""
    arr = np.array(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    out = torch.tensor(arr, device=device)
    return out.requires_grad_(True) if requires_grad else out


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(ref, got, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(n(got), n(ref), atol=atol, rtol=rtol, err_msg=name)


def assert_close_to_max(ref, got, rel, name=""):
    """max |got - ref| <= rel * max |ref|: for gradients whose entries span
    many magnitudes and whose sums run in another order."""
    ref, got = n(ref), n(got)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rel * scale + 1e-30, f"{name}: max|diff| {err} > {rel} * {scale}"


def assert_close_per_column(ref, got, rel, floor_rel, name=""):
    """In each column c of (E, K) arrays: max |got_c - ref_c| <= rel *
    max |ref_c| + floor_rel * max |ref|. For grad slabs whose columns
    differ by orders of magnitude, so that a small column cannot hide
    under a large one's bound."""
    ref, got = n(ref), n(got)
    err = np.abs(got - ref).max(axis=0)
    scale = np.abs(ref).max(axis=0)
    bound = rel * scale + floor_rel * scale.max()
    bad = np.flatnonzero(err > bound)
    assert bad.size == 0, f"{name}: columns {bad}: max|diff| {err[bad]} > {bound[bad]}"


def grad_parity(jfn, tfn, inputs, atol=1e-6, rtol=1e-5):
    """Value and gradient (of sum(out * w), w fixed random) parity of a JAX
    function and its port on the same numpy inputs."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    jout = jfn(*[jnp.asarray(x) for x in inputs])
    w = rng.normal(size=np.shape(jout)).astype(np.float32)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(inputs)))
    )(*[jnp.asarray(x) for x in inputs])
    targs = [t(x, requires_grad=True) for x in inputs]
    tout = tfn(*targs)
    assert_close(jout, tout, atol, rtol, "value")
    (tout * t(w)).sum().backward()
    for i, (jg, ta) in enumerate(zip(jgrads, targs)):
        got = ta.grad if ta.grad is not None else torch.zeros_like(ta)  # unused input
        assert_close(jg, got, atol, rtol, f"grad {i}")


def make_scene(rng, n=200, spread=0.8, res=64, frames=1):
    """Random surfel cloud in front of a pinhole camera (numpy, float32):
    means (F, P, 3), quats (F, P, 4), scales (P, 2), opacity (P,),
    colours (F, P, 3), intrinsics (F, 4)."""
    means = rng.normal(size=(n, 3)) * spread + np.array([0.0, 0.0, 3.0])
    means = np.stack([means + f * np.array([0.1, -0.05, 0.2]) for f in range(frames)])
    quats = rng.normal(size=(frames, n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(n, 2)) * 0.5) * 0.05
    opac = 1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))
    colors = rng.uniform(size=(frames, n, 3))
    intrins = np.tile([res * 60.0 / 64, res * 60.0 / 64, res / 2.0, res / 2.0], (frames, 1))
    f32 = lambda a: np.asarray(a, np.float32)
    return tuple(map(f32, (means, quats, scales, opac, colors, intrins)))


def ellipsoid_mesh(axes, n_lat, n_lon):
    """A closed triangulated ellipsoid shell centred at the origin: two
    poles and n_lat - 1 rings of n_lon vertices; 2 n_lon (n_lat - 1) faces,
    wound outwards."""
    theta = np.pi * np.arange(1, n_lat) / n_lat
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None],
                     np.sin(theta)[:, None] * np.sin(phi)[None],
                     np.cos(theta)[:, None] * np.ones(n_lon)[None]], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * np.asarray(axes)
    last = len(verts) - 1
    j, j1 = np.arange(n_lon), (np.arange(n_lon) + 1) % n_lon
    faces = [np.stack([np.zeros(n_lon, int), 1 + j, 1 + j1], -1)]
    for i in range(n_lat - 2):
        a, b = 1 + i * n_lon, 1 + (i + 1) * n_lon
        faces += [np.stack([a + j, b + j, b + j1], -1), np.stack([a + j, b + j1, a + j1], -1)]
    a = 1 + (n_lat - 2) * n_lon
    faces.append(np.stack([np.full(n_lon, last), a + j1, a + j], -1))
    return verts.astype(np.float32), np.concatenate(faces).astype(np.int32)


def write_stage2_output(s2_dir, db, res, rng, mesh=(96, 128), axes=(0.10, 0.12, 0.07),
                        depth=0.38, scale=0.8):
    """A Stage-2 output for the database ``db`` (res x res) in ``s2_dir``:
    the mesh ``000-fg-geo.obj`` (`ellipsoid_mesh` of semi-axes ``axes``,
    ``mesh`` = (rings + 1, meridians)), its vertex colours
    ``000-fg-geo-colors.npy`` and 16-dim vertex features
    ``000-fg-feat.npy`` (drawn from ``rng``), and a Stage-2-layout
    ``ckpt_latest.pth``: ``{"params": {"params": {"fields_fg": {warp,
    camera_mlp, logscale}, "intrinsics": ...}}}`` from a seeded port
    deformer whose camera MLP gives the identity rotation at ``depth`` in
    every frame, whose intrinsics are the pixel-true prior and whose
    logscale is log(``scale``). Returns (mesh path, checkpoint path, the
    source deformer's state dict)."""
    import os
    import pickle

    from vidu4d_tpu_torch import convert
    from vidu4d_tpu_torch.data import data_utils
    from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu_torch.models.gaussian.deformable import GaussianDeformer
    from vidu4d_tpu_torch.ops.marching import save_obj

    verts, faces = ellipsoid_mesh(axes, *mesh)
    mesh_path = os.path.join(s2_dir, "000-fg-geo.obj")
    save_obj(mesh_path, verts, faces)
    np.save(os.path.join(s2_dir, "000-fg-geo-colors.npy"),
            np.clip(verts / (2 * np.asarray(axes)) + 0.5, 0, 1).astype(np.float32))
    np.save(os.path.join(s2_dir, "000-fg-feat.npy"),
            rng.normal(size=(len(verts), 16)).astype(np.float32))

    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop", "train_res": res}
    fi = data_utils.get_data_info(data_utils.build_datasets(
        opts, rng=np.random.default_rng(0)))["frame_info"]
    d = GaussianDeformer(fi, "bob", device="cpu", generator=torch.Generator().manual_seed(5))
    n_frames = int(np.asarray(fi.frame_offset)[-1])
    init_intrinsics_base_params(d.intrinsics, np.tile(np.array(
        [1.2 * res, 1.2 * res, res / 2, res / 2], np.float32), (n_frames, 1)), fi)
    with torch.no_grad():
        d.logscale.fill_(float(np.log(scale)))
        for head, bias in ((d.camera_mlp.trans_head, (0.0, 0.0, depth)),
                           (d.camera_mlp.quat_head, (1.0, 0.0, 0.0, 0.0))):
            head.out.weight.zero_()
            head.out.bias.copy_(torch.tensor(bias))
    tree = convert.state_dict_to_flax(d.state_dict())["params"]
    params = {"params": {"fields_fg": {k: tree[k] for k in ("warp", "camera_mlp", "logscale")},
                         "intrinsics": tree["intrinsics"]}}
    ckpt = os.path.join(s2_dir, "ckpt_latest.pth")
    with open(ckpt, "wb") as f:
        pickle.dump({"current_steps": 0, "current_round": 20, "params": params}, f)
    return mesh_path, ckpt, {k: v.detach().clone() for k, v in d.state_dict().items()}


def look_at(eye, target=(0.0, 0.0, 0.0), down=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(4, 4) float32 world-to-camera matrix (x right, y down, z forward)
    of a camera at ``eye`` looking at ``target``; ``down`` is the world
    direction that appears downwards."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(np.asarray(down, np.float64), fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd])
    vm = np.eye(4)
    vm[:3, :3], vm[:3, 3] = rot, -rot @ eye
    return vm.astype(np.float32)


def write_colmap_scene(root, viewmats, intrins, width, height, images, points, colors):
    """A COLMAP binary reconstruction in ``root``: ``sparse/0/cameras.bin``
    (one PINHOLE camera, intrinsics fx, fy, cx, cy), ``images.bin`` (one
    image per viewmat, named ``NNN.png``, no 2D points), ``points3D.bin``
    (points (N, 3), colours (N, 3) in [0, 1], empty tracks) and the images
    (uint8 (H, W, 3)) under ``images/``."""
    import os
    import struct

    from vidu4d_tpu_torch.utils.io import write_png

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, width, height)
                + struct.pack("<4d", *[float(v) for v in intrins]))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(viewmats)))
        for i, vm in enumerate(viewmats):
            f.write(struct.pack("<I", i + 1) + struct.pack("<4d", *rot_to_qvec(vm[:3, :3]))
                    + struct.pack("<3d", *[float(v) for v in vm[:3, 3]])
                    + struct.pack("<I", 1) + f"{i:03d}.png".encode() + b"\x00"
                    + struct.pack("<Q", 0))
    rgb = np.clip(np.round(np.asarray(colors) * 255), 0, 255).astype(np.uint8)
    rows = np.zeros(len(points), dtype=[("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                        ("err", "<f8"), ("track", "<u8")])
    rows["id"] = np.arange(1, len(points) + 1)
    rows["xyz"], rows["rgb"] = points, rgb
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)) + rows.tobytes())
    for i, img in enumerate(images):
        write_png(os.path.join(root, "images", f"{i:03d}.png"), img)


def static_scene(root, rng, n_gt, n_init, n_cams, width, height, device="cpu"):
    """A synthetic static scene written as a COLMAP reconstruction in
    ``root``: ``n_gt`` opaque ground-truth surfels tangent to an ellipsoid
    shell of semi-axes 1.6, 1.1, 1.6 (colours a smooth texture of
    position), rendered by the port (`ops.rasterize.rasterize`, SH degree
    0, black background) from ``n_cams`` cameras on a ring at 4.5 around it
    (PINHOLE, focal 1010 / 1237 x width, principal point at the centre)
    into ``width`` x ``height`` PNGs; and ``n_init`` initial points:
    ground-truth centres with 2% noise of the mean axis and uniform random
    colours."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import rasterize
    from vidu4d_tpu_torch.ops.sh import rgb_to_sh

    axes, cam_dist, focal = np.array([1.6, 1.1, 1.6]), 4.5, 1010.0 / 1237
    u = rng.normal(size=(n_gt, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pts = u * axes
    normal = pts / axes ** 2
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    tangent = np.cross(normal, rng.normal(size=(n_gt, 3)))
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    rot = np.stack([tangent, np.cross(normal, tangent), normal], axis=-1)  # columns
    quats = rot_to_qvec(rot)
    cols = 0.5 + 0.4 * np.stack([np.sin(3.0 * pts[:, 0] + 1.0), np.sin(4.0 * pts[:, 1]),
                                 np.cos(3.5 * pts[:, 2] - 0.5 * pts[:, 0])], axis=-1)
    area = 4 * np.pi * (np.prod(axes) ** (2 / 3))  # ~ the ellipsoid's area
    sigma = 0.8 * np.sqrt(area / n_gt)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    intrins = np.array([focal * width, focal * width, width / 2, height / 2], np.float32)
    viewmats, images = [], []
    with torch.no_grad():
        for k in range(n_cams):
            ang = 2 * np.pi * k / n_cams
            eye = cam_dist * np.array([np.sin(ang), -0.25, np.cos(ang)])
            vm = look_at(eye)
            out = rasterize(t(pts), t(quats), t(np.full((n_gt, 2), sigma)),
                            t(np.full(n_gt, 0.9)), t(vm), t(intrins), height, width,
                            shs=t(rgb_to_sh(torch.as_tensor(cols)).numpy()[:, None, :]),
                            sh_degree=0)
            viewmats.append(vm)
            images.append(np.round(np.clip(out.color.cpu().numpy(), 0, 1) * 255)
                          .astype(np.uint8))
    init = rng.choice(n_gt, size=n_init, replace=n_init > n_gt)
    init_pts = pts[init] + rng.normal(size=(n_init, 3)) * 0.02 * axes.mean()
    write_colmap_scene(root, viewmats, intrins, width, height, images, init_pts,
                       rng.uniform(size=(n_init, 3)))


def rot_to_qvec(rot: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> COLMAP's (w, x, y, z) unit
    quaternions (..., 4) with w >= 0 (the branch on the largest of w, x,
    y, z, vectorised)."""
    lead = np.shape(rot)[:-2]
    m = np.asarray(rot, np.float64).reshape(-1, 3, 3)
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    cand = np.stack([tr, m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], axis=-1)
    which = np.argmax(cand, axis=-1)
    q = np.zeros((len(m), 4))
    for b in range(4):
        s = which == b
        r = m[s]
        if b == 0:
            d = np.sqrt(1.0 + tr[s]) * 2
            q[s] = np.stack([0.25 * d, (r[:, 2, 1] - r[:, 1, 2]) / d,
                             (r[:, 0, 2] - r[:, 2, 0]) / d, (r[:, 1, 0] - r[:, 0, 1]) / d], -1)
        else:
            i, j, k = (b - 1), b % 3, (b + 1) % 3
            d = np.sqrt(1.0 + r[:, i, i] - r[:, j, j] - r[:, k, k]) * 2
            qq = np.zeros((len(r), 4))
            qq[:, 0] = (r[:, k, j] - r[:, j, k]) / d
            qq[:, 1 + i] = 0.25 * d
            qq[:, 1 + j] = (r[:, j, i] + r[:, i, j]) / d
            qq[:, 1 + k] = (r[:, k, i] + r[:, i, k]) / d
            q[s] = qq
    return (q * np.where(q[:, :1] < 0, -1.0, 1.0)).reshape(lead + (4,))


def jax_time_code_in_default_float(monkeypatch):
    """Make the JAX package's TimeEmbedding compute the frame time in the
    default float type (float64 under ``jax.enable_x64``, else float32, as
    before): it casts to float32 (`embeddings.py:117`), which puts float32
    rounding into every time-conditioned output of a float64 comparison."""
    import jax.numpy as jnp

    from vidu4d_tpu.models.fields.embeddings import TimeEmbedding

    def frame_to_tid(self, frame_id):
        frame_id = frame_id.astype(jnp.int32)
        vid_len = self._raw_fid_to_vidlen[frame_id]
        tid_sub = frame_id.astype(jnp.result_type(float)) - self._raw_fid_to_vstart[frame_id]
        return (tid_sub - vid_len / 2.0) / self._max_ts * 2.0 * self.time_scale

    monkeypatch.setattr(TimeEmbedding, "frame_to_tid", frame_to_tid)
