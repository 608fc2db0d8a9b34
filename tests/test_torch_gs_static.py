"""The port's static 2DGS path against the JAX package's, on the CPU: the
single-camera `rasterize`, `train_step`, the `train` loop, the scene and
image readers, the command lines and the viewer bridge.

Tolerances:
* `rasterize` (plain versions of the tile kernels) vs JAX ``impl="tiles"``:
  outputs atol 5e-4 / rtol 1e-3, gradients atol 1e-5 / rtol 1e-4, the
  bounds of tests/test_torch_rasterize.py (the slab's affine intersection
  rounds differently from the tiles path's cross product). That rounding
  can move a splat's alpha across the 1/255 cut at a pixel: such a pixel
  differs by at most one splat's 1/255 in alpha, is left out of the
  output comparison, and at most that many splats (gradient rows) may
  differ beyond the bound, each within 5e-3 of its field's largest
  |gradient| (the seed's scene has one: pixel (9, 44), 7.9e-5 of 0.024 in
  one xyz row). No tile may hold more entries than the tiles path's
  ``budget``: it drops the rest, the kernels do not;
* `train_step`, 3 steps from one state: loss and PSNR to 1e-5 relative;
  Adam moments per field to 1e-3 of the field's largest |value| and
  grad_accum to 1e-3 of its max (measured: loss 2.9e-7 relative, moments
  <= 6.4e-4, the rotation's at step 3, where gradients sum large terms of
  both signs, grad_accum 1.5e-4); parameters to 2e-6 + 3 lr x steps of the
  field (Adam's step is ~lr g / |g|: where g is near 0 its sign can flip);
  denom and max_radii2d exactly;
* the `train` loop (30 steps, JAX's camera indices and split noise, resets
  at 5 and 15, densify at 10 and 20, SH raised at 10, 20 and 30): every
  hook's counts and alive mask equal, the logged losses to 1e-4 relative
  (measured 5e-7). The two runs drift apart slowly, so the final state is
  held to wider bounds: moments 5e-2 of their max, grad_accum 2e-2
  (measured at step 30: moments <= 1.5e-2, the xyz first moment's; 2.0e-2
  at step 20; grad_accum 6.2e-3), parameters as above;
* readers: exactly.
"""

import json
import math
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, assert_close_to_max, n, static_scene, t
from vidu4d_tpu.engine import gs_trainer as jg
from vidu4d_tpu.models.gaussian import densify as jdn
from vidu4d_tpu.models.gaussian import surfels as jsf
from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init as j_adam_init
from vidu4d_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from vidu4d_tpu.ops.rasterize import common as jc
from vidu4d_tpu.ops.rasterize import rasterize as jrasterize
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.data import scene_readers as tsr
from vidu4d_tpu_torch.engine import gs_trainer as tg
from vidu4d_tpu_torch.models.gaussian import densify as tdn
from vidu4d_tpu_torch.models.gaussian import surfels as tsf
from vidu4d_tpu_torch.ops.rasterize import rasterize as trasterize
from vidu4d_tpu_torch.ops.rasterize.common import ALPHA_EPS
from vidu4d_tpu_torch.utils import io as tio
from vidu4d_tpu_torch.utils import network_gui as tgui

SMOOTH = ("color", "depth", "alpha", "normal", "distortion", "final_t")
H, W, CAP, N_INIT = 40, 48, 1024, 512
# shared by the train_step and train tests, so JAX compiles its step once
# per SH degree: densify at 10 and 20 (size rules on at 20), opacity reset
# at 5 (white background) and 15, SH raised at 10, 20, 30
CONFIG = dict(iterations=30, sh_increase_interval=10, densify_from_iter=5,
              densification_interval=10, densify_until_iter=25,
              opacity_reset_interval=15, white_background=True)


def _raster_loss(out, lib):
    return (lib.mean(out.color ** 2) + 0.3 * lib.mean(out.depth) + 0.2 * lib.mean(out.alpha)
            + 0.1 * lib.mean(out.normal) + 0.5 * lib.mean(out.distortion))


def test_rasterize_matches_jax_tiles_values_and_grads():
    """Single camera at 40x56 (3 x 4 tiles, the last row and column cut),
    SH degree 3 at the camera centre, white background, densify dummy:
    every non-median output and the gradients of every input."""
    rng = np.random.default_rng(0)
    p = 160
    f32 = lambda a: np.asarray(a, np.float32)
    means = f32(rng.normal(size=(p, 3)) * [0.8, 0.6, 0.5] + [0.3, -0.2, 0.4])
    quats = f32(rng.normal(size=(p, 4)))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = f32(np.exp(rng.normal(size=(p, 2)) * 0.4) * 0.06)
    opac = f32(1 / (1 + np.exp(-rng.normal(size=p))))
    shs = f32(rng.normal(size=(p, 16, 3)) * 0.3)
    bg = np.ones(3, np.float32)
    dummy = np.zeros((p, 2), np.float32)
    ang = 0.3
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    viewmat[:3, 3] = [0.1, 0.05, 3.0]
    intrins = np.array([50.0, 52.0, 27.5, 21.0], np.float32)
    h, w = 40, 56
    cfg = JRasterizeConfig(impl="tiles")

    proj = jc.project_splats(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
                             jnp.asarray(viewmat), jnp.asarray(intrins))
    counts = np.asarray(jc.bin_splats(proj, h, w, tile=16, span_cap=4).tile_count)
    assert counts.max() <= cfg.budget and counts.sum() > 0, counts

    def jloss(means, quats, scales, opac, shs, bg, dummy):
        out = jrasterize(means, quats, scales, opac, jnp.asarray(viewmat),
                         jnp.asarray(intrins), h, w, shs=shs, sh_degree=3, bg_color=bg,
                         densify_dummy=dummy, config=cfg)
        return _raster_loss(out, jnp), out

    args = [means, quats, scales, opac, shs, bg, dummy]
    (jv, jout), jgr = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(7)),
                                                 has_aux=True))(*map(jnp.asarray, args))
    targs = [t(a, True) for a in args]
    m_, q_, s_, o_, sh_, b_, d_ = targs
    out = trasterize(m_, q_, s_, o_, t(viewmat), t(intrins), h, w, shs=sh_, sh_degree=3,
                     bg_color=b_, densify_dummy=d_)
    assert out.color.shape == (h, w, 3) and out.normal.shape == (h, w, 3)
    tv = _raster_loss(out, torch)
    tv.backward()
    d_alpha = np.abs(n(out.alpha) - n(jout.alpha))
    flips = d_alpha > 5e-4
    assert flips.sum() <= 2 and np.all(d_alpha[flips] <= ALPHA_EPS * (1 + 1e-3)), \
        d_alpha[flips]
    for f in SMOOTH:
        assert_close(n(getattr(jout, f))[~flips], n(getattr(out, f))[~flips], 5e-4, 1e-3, f)
    assert_close(jv, tv, 0.0, 3e-5, "loss")
    for name, jg_, ta in zip(["xyz", "quats", "scales", "opacity", "shs", "bg", "dummy"],
                             jgr, targs):
        ref, got = n(jg_), n(ta.grad)
        bad = (np.abs(got - ref) > 1e-5 + 1e-4 * np.abs(ref)).reshape(len(ref), -1).any(1)
        assert bad.sum() <= flips.sum(), (name, np.flatnonzero(bad))
        assert_close_to_max(ref, got, 5e-3, name)
    assert float(torch.abs(d_.grad).max()) > 0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 48x40 COLMAP scene (6 cameras, 2000 ground-truth surfels, 512
    initial points), its cameras as numpy, the JAX initial state in 1024
    slots and the JAX config."""
    root = str(tmp_path_factory.mktemp("static_scene"))
    static_scene(root, np.random.default_rng(3), 2000, N_INIT, 6, W, H)
    sc = tsr.read_scene(root)
    cams = []
    for c in sc.train_cameras:
        img = tio.read_image(c.image_path).astype(np.float32) / 255.0
        cams.append((c.viewmat, c.intrins, img))
    state = jsf.init_from_points(jnp.asarray(sc.points), jnp.asarray(sc.colors), CAP,
                                 sh_degree=3)
    return {"root": root, "scene": sc, "cams": cams, "state": state,
            "config": jg.GsTrainConfig(**CONFIG)}


def _port_state(jstate, jadam=None):
    np_state = jax.tree.map(np.asarray, jstate)
    ts = convert.surfel_state_from_jax(np_state, "cpu")
    ta = (tg.gs_adam_init(ts.params) if jadam is None
          else convert.gs_adam_from_jax(jax.tree.map(np.asarray, jadam), "cpu"))
    return ts, ta


def _port_config(config):
    return tg.GsTrainConfig(**{k: v for k, v in config._asdict().items()
                               if k not in ("raster", "lrs")})


def _field_lr(config, field, steps):
    lrs = config.lrs
    return {"xyz": lrs.xyz_init, "features_dc": lrs.features_dc,
            "features_rest": lrs.features_rest, "scaling": lrs.scaling,
            "rotation": lrs.rotation, "opacity": lrs.opacity,
            "regist_feat": lrs.regist_feat}[field] * steps


def _compare_states(js, ja, ts, ta, config, steps, mom_rel, accum_rel):
    for f in tsf.SurfelParams._fields:
        ref, got = getattr(js.params, f), getattr(ts.params, f)
        assert_close(ref, got, 2e-6 + 3 * _field_lr(config, f, steps), 0.0, f"param {f}")
        for mom in ("mu", "nu"):
            assert_close_to_max(getattr(getattr(ja, mom), f), getattr(getattr(ta, mom), f),
                                mom_rel, f"{mom} {f}")
    np.testing.assert_array_equal(n(js.alive), n(ts.alive))
    assert_close_to_max(js.grad_accum, ts.grad_accum, accum_rel, "grad_accum")
    np.testing.assert_array_equal(n(js.denom), n(ts.denom))
    np.testing.assert_array_equal(n(js.max_radii2d), n(ts.max_radii2d))


def test_train_step_matches_jax(scene):
    """3 steps at active SH 3 (cameras 0, 1, 2) from the JAX initial state."""
    config = scene["config"]
    js, ja = scene["state"], j_adam_init(scene["state"].params)
    ts, ta = _port_state(js)
    tcfg = _port_config(config)
    for k in range(3):
        vm, intr, img = scene["cams"][k]
        js, ja, jm = jg.train_step(js, ja, jnp.asarray(vm), jnp.asarray(intr),
                                   jnp.asarray(img), H, W, 3, config)
        ts, ta, tm = tg.train_step(ts, ta, t(vm), t(intr), t(img), H, W, 3, tcfg)
        for key in ("loss", "psnr"):
            assert_close(jm[key], tm[key], 0.0, 1e-5, key)
        assert int(jm["alive"]) == int(tm["alive"]) == N_INIT
        _compare_states(js, ja, ts, ta, config, k + 1, 1e-3, 1e-3)
    assert ta.count == 3 and float(ts.denom.max()) == 3.0


def test_train_loop_matches_jax(scene, monkeypatch):
    """`train` for 30 steps with every hook: JAX's camera indices and split
    noise replayed into the port through `LoopDraws`; each densify's counts,
    the alive masks after each hook and the logged metrics."""
    config = scene["config"]
    cams = scene["cams"]
    key = jax.random.PRNGKey(1)
    draws = {}
    for it in range(1, config.iterations + 1):
        key, k_cam, k_den = jax.random.split(key, 3)
        draws[it] = (int(jax.random.randint(k_cam, (), 0, len(cams))),
                     np.asarray(jax.random.normal(k_den, (CAP, 2, 2), jnp.float32)))
    monkeypatch.setattr(tg.LoopDraws, "camera_index", lambda self, it, n_cam: draws[it][0])
    monkeypatch.setattr(tg.LoopDraws, "split_noise",
                        lambda self, it, shape, device: t(draws[it][1]))

    log = {"jax": [], "port": []}

    def recorder(label, fn, module):
        def wrapped(state, *a, **kw):
            out = fn(state, *a, **kw)
            info = {k: int(v) for k, v in out[2].items()}
            log[label].append(("densify", info, n(out[0].alive).copy()))
            return out
        return wrapped

    def reset_recorder(label, fn):
        def wrapped(state, adam):
            out = fn(state, adam)
            log[label].append(("reset", {}, n(out[0].alive).copy()))
            return out
        return wrapped

    monkeypatch.setattr(jg, "densify_step", recorder("jax", jg.densify_step, jg))
    monkeypatch.setattr(tg, "densify_step", recorder("port", tg.densify_step, tg))
    monkeypatch.setattr(jdn, "reset_opacity", reset_recorder("jax", jdn.reset_opacity))
    monkeypatch.setattr(tdn, "reset_opacity", reset_recorder("port", tdn.reset_opacity))

    jt_cams = [jg.Camera(jnp.asarray(vm), jnp.asarray(k), jnp.asarray(img))
               for vm, k, img in cams]
    tt_cams = [tg.Camera(t(vm), t(k), t(img)) for vm, k, img in cams]
    extent = scene["scene"].extent
    js, ja, jhist = jg.train(scene["state"], jt_cams, config, extent, key=jax.random.PRNGKey(1),
                             log_every=5)
    ts0, _ = _port_state(scene["state"])
    ts, ta, thist = tg.train(ts0, tt_cams, _port_config(config), extent, log_every=5)

    assert [e[0] for e in log["jax"]] == ["reset", "densify", "reset", "densify"]
    assert [(e[0], e[1]) for e in log["port"]] == [(e[0], e[1]) for e in log["jax"]]
    for (_, _, jalive), (_, _, talive) in zip(log["jax"], log["port"]):
        np.testing.assert_array_equal(jalive, talive)
    densified = [e[1] for e in log["jax"] if e[0] == "densify"]
    assert sum(d["cloned"] + d["split"] for d in densified) > 0, densified
    assert [h["iter"] for h in jhist] == [h["iter"] for h in thist] == [5, 10, 15, 20, 25, 30]
    for jh, th in zip(jhist, thist):
        assert set(jh) == set(th)
        assert_close(jh["loss"], th["loss"], 0.0, 1e-4, f"loss at {jh['iter']}")
        assert jh["alive"] == th["alive"]
    _compare_states(js, ja, ts, ta, config, config.iterations, 5e-2, 2e-2)


def _encode_png(img, filters):
    """PNG bytes of a uint8 (H, W, C) image with row y filtered by
    filters[y % len(filters)] (types 0-4), for the decoder's own test."""
    import struct
    import zlib

    h, w, c = img.shape
    bpp = c
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.fixture
def no_imageio(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_all_filters(tmp_path, no_imageio, channels):
    """Without imageio: every row filter (0-4) decodes exactly, for grey,
    RGB and RGBA; write_png round-trips."""
    rng = np.random.default_rng(channels)
    img = (rng.uniform(size=(23, 17, channels)) * 255).astype(np.uint8)
    img[5:9] = img[4]  # repeated rows, so Up / Paeth predict exactly
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, [0, 1, 2, 3, 4]))
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(tio.read_image(str(path)), want)
    tio.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "w.png")), want)


def test_read_image_without_imageio_raises_for_other_files(tmp_path, no_imageio):
    jpg = tmp_path / "a.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    with pytest.raises(ValueError, match="a.jpg"):
        tio.read_image(str(jpg))
    img16 = tmp_path / "deep.png"
    png = bytearray(_encode_png(np.zeros((2, 2, 3), np.uint8), [0]))
    png[24] = 16  # IHDR bit depth
    img16.write_bytes(bytes(png))
    with pytest.raises(ValueError, match="deep.png"):
        tio.read_image(str(img16))


@pytest.mark.parametrize("channels", [3, 4])
def test_read_image_matches_imageio(tmp_path, channels, monkeypatch):
    """The decoder against imageio on PNGs imageio wrote (its own filter
    choice)."""
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(10 + channels)
    img = (rng.uniform(size=(31, 45, channels)) * 255).astype(np.uint8)
    img[:, 20:] = img[:, 19:20]  # flat areas make the writer pick other filters
    path = str(tmp_path / "i.png")
    imageio.imwrite(path, img)
    want = imageio.imread(path)
    np.testing.assert_array_equal(tio.read_image(path), want)
    import sys

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    np.testing.assert_array_equal(tio.read_image(path), want)


def test_scene_readers_match_jax(scene, tmp_path):
    """read_colmap_scene (with and without the eval split) and
    read_blender_scene give the JAX readers' cameras, points and extents."""
    from vidu4d_tpu.data import scene_readers as jsr

    def same(a, b):
        assert len(a.train_cameras) == len(b.train_cameras)
        assert len(a.test_cameras) == len(b.test_cameras)
        for ca, cb in zip(a.train_cameras + a.test_cameras, b.train_cameras + b.test_cameras):
            np.testing.assert_array_equal(ca.viewmat, cb.viewmat)
            np.testing.assert_array_equal(ca.intrins, cb.intrins)
            assert (ca.image_path, ca.width, ca.height) == (cb.image_path, cb.width, cb.height)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.colors, b.colors)
        assert a.extent == b.extent

    root = scene["root"]
    same(jsr.read_scene(root), tsr.read_scene(root))
    same(jsr.read_colmap_scene(root, eval_split=True, llffhold=4),
         tsr.read_colmap_scene(root, eval_split=True, llffhold=4))

    rng = np.random.default_rng(4)
    blender = tmp_path / "blender"
    blender.mkdir()
    for split, k in (("train", 3), ("test", 2)):
        frames = []
        for i in range(k):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        (blender / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    same(jsr.read_scene(str(blender)), tsr.read_scene(str(blender)))
    with pytest.raises(ValueError):
        tsr.read_scene(str(tmp_path))


def test_gs_static_and_full_eval_cli(scene, tmp_path):
    """`gs_static.main` and `full_eval.main --skip_missing` end to end with
    --device cpu on the 48x40 scene (100 steps, so one history entry): the
    JAX artifact set (point_cloud.ply, history.json with the eval keys,
    fused_mesh.obj) and full_eval's results.json."""
    from vidu4d_tpu_torch import full_eval, gs_static
    from vidu4d_tpu_torch.models.gaussian.ply_io import load_ply

    common = ["--iterations=100", "--densify_from_iter=40", "--densification_interval=30",
              "--densify_until_iter=80", "--opacity_reset_interval=70",
              "--gs_capacity=256", "--device=cpu"]
    out = tmp_path / "out"
    gs_static.main([f"--source_path_={scene['root']}", f"--model_path_={out}", *common])
    assert sorted(os.listdir(out)) == ["fused_mesh.obj", "history.json", "point_cloud.ply"]
    hist = json.loads((out / "history.json").read_text())
    assert len(hist) == 1
    assert set(hist[0]) == {"loss", "psnr", "alive", "iter", "elapsed", "eval_psnr",
                            "eval_ssim", "eval_lpips", "lpips_kind"}
    assert hist[0]["lpips_kind"] == "vgg16-random-pinned-torch"
    assert all(np.isfinite(hist[0][k]) for k in ("loss", "eval_psnr", "eval_ssim", "eval_lpips"))
    _, rows = load_ply(str(out / "point_cloud.ply"))
    assert rows == hist[0]["alive"]

    m360 = tmp_path / "m360"
    m360.mkdir()
    os.symlink(scene["root"], m360 / "room")  # indoor: downscale 2, 24 x 20
    eval_dir = tmp_path / "eval"
    results = full_eval.main(["--mipnerf360", str(m360), "--output_path", str(eval_dir),
                              "--iterations", "100", "--skip_missing", *common[1:]])
    assert list(results) == ["room"]
    assert json.loads((eval_dir / "results.json").read_text()) == results
    assert sorted(os.listdir(eval_dir / "room")) == ["fused_mesh.obj", "history.json",
                                                       "point_cloud.ply"]
    with pytest.raises(FileNotFoundError):
        full_eval.main(["--mipnerf360", str(m360), "--output_path", str(eval_dir),
                        "--device=cpu"])


def test_gs_static_requires_cuda_unless_cpu(scene, tmp_path, monkeypatch):
    from vidu4d_tpu_torch import gs_static

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gs_static.main([f"--source_path_={scene['root']}", f"--model_path_={tmp_path}"])


# the viewer bridge (tests/test_network_gui.py's cases, against the port's
# copy), plus the port's render callback

def _recv_exact(conn, nbytes):
    buf = b""
    while len(buf) < nbytes:
        chunk = conn.recv(nbytes - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def test_viewer_round_trip():
    server = tgui.ViewerServer(port=0, source_path="/data/synth")
    try:
        client = socket.create_connection(("127.0.0.1", server.port))
        vw, vh = 32, 24
        viewmat = np.eye(4, dtype=np.float32)
        viewmat[2, 3] = 0.5
        client.sendall(tgui.make_request(vw, vh, viewmat, fovx=1.0, fovy=0.8))
        captured = {}

        def render_fn(cam):
            captured["cam"] = cam
            img = np.zeros((cam.height, cam.width, 3), np.float32)
            img[..., 0] = 1.0
            return img

        assert server.poll(render_fn) == 1
        img = np.frombuffer(_recv_exact(client, vh * vw * 3), np.uint8).reshape(vh, vw, 3)
        assert (img[..., 0] == 255).all() and (img[..., 1:] == 0).all()
        size = int.from_bytes(_recv_exact(client, 4), "little")
        assert _recv_exact(client, size).decode("ascii") == "/data/synth"
        cam = captured["cam"]
        assert (cam.width, cam.height) == (vw, vh)
        np.testing.assert_allclose(cam.viewmat, viewmat, atol=1e-6)
        np.testing.assert_allclose(cam.intrins[0], vw / (2 * math.tan(0.5)), rtol=1e-6)
        client.close()
    finally:
        server.close()


def test_viewer_keepalive_and_disconnect():
    server = tgui.ViewerServer(port=0)
    try:
        client = socket.create_connection(("127.0.0.1", server.port))
        payload = json.dumps({"resolution_x": 0, "resolution_y": 0, "train": True}).encode()
        client.sendall(len(payload).to_bytes(4, "little") + payload)
        assert server.poll(lambda cam: (_ for _ in ()).throw(AssertionError)) == 0
        assert int.from_bytes(_recv_exact(client, 4), "little") == 0
        client.close()
        assert server.poll(lambda cam: None) == 0
        assert server.conn is None
    finally:
        server.close()


def test_parse_request_rejects_zero_resolution():
    msg = json.loads(tgui.make_request(0, 0, np.eye(4), 1.0, 1.0)[4:])
    msg["resolution_x"] = msg["resolution_y"] = 0
    assert tgui.parse_request(msg) is None


def test_encode_image_clamps():
    img = np.array([[[-0.5, 0.5, 1.5]]], np.float32)
    assert tgui.encode_image(img) == bytes([0, 127, 255])


def test_render_viewer_frame_matches_jax(scene):
    """A viewer request at scaling_modifier 0.7 rendered by both packages'
    callbacks from the initial state."""
    vm, intr, _ = scene["cams"][2]
    msg = json.loads(tgui.make_request(W, H, vm, fovx=1.1, fovy=0.9, scaling_modifier=0.7)[4:])
    cam = tgui.parse_request(msg)
    jimg = jg.render_viewer_frame(scene["state"], cam, 1, scene["config"])
    ts, _ = _port_state(scene["state"])
    timg = tg.render_viewer_frame(ts, cam, 1, _port_config(scene["config"]))
    assert timg.shape == (H, W, 3)
    assert_close(jimg, timg, 5e-4, 1e-3, "viewer frame")
