"""The port's LPIPS, metrics and DSSIM loss against the JAX package's, on
the CPU.

Tolerances: the LPIPS graph on JAX's own fallback filters to 1e-5 relative
(float32 convolutions summed in another order; measured 2.8e-6);
`dssim_l1_loss`, PSNR and SSIM to 1e-5 relative. The port's fallback
filters are its own (a torch generator, not JAX's PRNGKey), so its LPIPS
is held to the JAX test's properties, under its own ``kind``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, t
from vidu4d_tpu.ops import image_losses as jil
from vidu4d_tpu.ops import lpips as jlp
from vidu4d_tpu_torch import metrics as tmetrics
from vidu4d_tpu_torch.ops import image_losses as til
from vidu4d_tpu_torch.ops import lpips as tlp
from vidu4d_tpu_torch.utils.io import write_png


def _pair(seed, shape=(2, 40, 56, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + noise * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("with_lin", [False, True])
def test_lpips_graph_matches_jax_on_its_filters(with_lin):
    """The port's VGG16 graph with JAX's `init_params()` filters (and, in
    the second case, random lin weights in the npz schema) vs JAX's
    `_lpips_impl`, on a batch of 2 non-square images (odd sizes after the
    pools: 40 x 56 -> 2 x 3 at the last tap)."""
    params, kind = jlp.init_params()
    assert kind == "vgg16-random-pinned"
    params = {k: np.asarray(v) for k, v in params.items()}
    if with_lin:
        rng = np.random.default_rng(1)
        for i, c in enumerate((64, 128, 256, 512, 512)):
            params[f"lin{i}_w"] = rng.uniform(size=c).astype(np.float32)
    a, b = _pair(0)
    ref = float(jlp._lpips_impl({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1)))
    net = tlp.LPIPSNet(params)
    got = float(net(t(a * 2 - 1).permute(0, 3, 1, 2), t(b * 2 - 1).permute(0, 3, 1, 2)))
    assert ref > 0 and abs(got - ref) <= 1e-5 * abs(ref), (ref, got)


def test_lpips_weights_file(tmp_path, monkeypatch):
    """An .npz in the JAX schema, from the argument or $VIDU4D_LPIPS_NPZ, is
    loaded (conv kernels transposed) and reported as pretrained."""
    params, _ = jlp.init_params()
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    a, b = _pair(2, (32, 48, 3))
    ref = float(jlp._lpips_impl(params, jnp.asarray(a * 2 - 1)[None],
                                jnp.asarray(b * 2 - 1)[None]))
    m = tlp.LPIPS(path)
    assert m.kind == "vgg16-pretrained" and abs(m(a, b) - ref) <= 1e-5 * ref
    w = np.asarray(params["conv2_1_w"])
    np.testing.assert_array_equal(m.net.convs["conv2_1"].weight.numpy(),
                                  w.transpose(3, 2, 0, 1))
    assert tlp.lpips_kind() == "vgg16-random-pinned-torch"
    monkeypatch.setenv("VIDU4D_LPIPS_NPZ", path)
    assert tlp.lpips_kind() == "vgg16-pretrained"


def test_lpips_fallback_properties():
    """tests/test_lpips.py's properties for the port's own pinned fallback."""
    m = tlp.LPIPS()
    assert m.kind == "vgg16-random-pinned-torch"
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    assert abs(m(img, img)) < 1e-6
    d_small = m(img, np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1))
    d_large = m(img, np.clip(img + 0.4 * rng.normal(size=img.shape), 0, 1))
    assert 0 < d_small < d_large
    assert abs(m(img, img * 0.5) - tlp.LPIPS()(img, img * 0.5)) < 1e-6
    assert abs(tlp.lpips(t(img), t(img * 0.5)) - m(img, img * 0.5)) < 1e-6
    with pytest.raises(ValueError, match="16 x 16"):
        m(img[:12], img[:12])


def test_dssim_l1_psnr_ssim_match_jax():
    a, b = _pair(3, (3, 37, 45))
    for lam in (0.0, 0.2, 1.0):
        assert_close(jil.dssim_l1_loss(jnp.asarray(a), jnp.asarray(b), lam),
                     til.dssim_l1_loss(t(a), t(b), lam), 0.0, 1e-5, f"dssim_l1 {lam}")
    assert_close(jil.psnr(jnp.asarray(a), jnp.asarray(b)), til.psnr(t(a), t(b)), 0.0, 1e-5)
    assert_close(jil.ssim(jnp.asarray(a), jnp.asarray(b)), til.ssim(t(a), t(b)), 0.0, 1e-5)


def test_compute_metrics_and_cli_match_jax(tmp_path):
    """`compute_metrics` on the same images: the JAX keys, PSNR and SSIM to
    1e-5, LPIPS under lpips_random with the port's kind; the command line
    over two PNG directories (read by the port's decoder)."""
    from vidu4d_tpu.metrics import compute_metrics as jcompute

    preds, gts = [], []
    for k in range(3):
        a, b = _pair(10 + k, (33, 47, 3), noise=0.05 * (k + 1))
        preds.append(np.round(a * 255) / 255)
        gts.append(np.round(b * 255) / 255)
    ref = jcompute(preds, gts)
    got = tmetrics.compute_metrics(preds, gts, device="cpu")
    assert set(got) == set(ref)
    for key in ("psnr", "ssim"):
        assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), key
    assert got["lpips"] is None and ref["lpips"] is None
    assert got["lpips_kind"] == "vgg16-random-pinned-torch" and got["n_images"] == 3
    assert 0 < got["lpips_random"]

    for d, imgs in (("pred", preds), ("gt", gts)):
        (tmp_path / d).mkdir()
        for k, img in enumerate(imgs):
            write_png(str(tmp_path / d / f"{k:03d}.png"), np.round(img * 255).astype(np.uint8))
    out = tmetrics.main([f"--pred_dir={tmp_path / 'pred'}", f"--gt_dir={tmp_path / 'gt'}",
                         "--device", "cpu"])
    assert json.loads(json.dumps(out)) == out
    for key in ("psnr", "ssim", "lpips_random"):
        assert abs(out[key] - got[key]) <= 1e-6 * abs(got[key]), key
    with pytest.raises(ValueError):
        tmetrics.main([f"--pred_dir={tmp_path / 'pred'}", f"--gt_dir={tmp_path}",
                       "--device", "cpu"])
