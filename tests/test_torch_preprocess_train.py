"""Stage 1's net training in the port (the losses, the weights files, the
optimisers, the data generators and the three trainers of
`vidu4d_tpu_torch.preprocess.train_{raft,featnet,depthnet}`) against the
JAX package's nets and `scripts/train_*.py`, on the CPU.

Everything runs in float32, as the JAX scripts do. Tolerances:
* the losses (`align_affine`, `ssi_mae`, `gradient_loss`, `depth_loss`,
  `ranking_loss` with JAX's own (ii, jj) pairs, `info_nce_pair`) within
  1e-5 relative, their gradients 1e-4 of the largest; `match_accuracy`
  equal;
* RAFT's sequence loss on a 32 x 32 pair from the shipped weights: 1e-4
  relative (the flows agree within 2e-4 px: test_torch_preprocess_nets.py);
* the loss of one DepthNet and one FeatNet step from the shipped weights
  within 1e-10 relative and every gradient within 1e-9 of its leaf's
  largest, in float64 (in float32 the convolutions' other summation order
  moves a FeatNet bias gradient by 2.6e-3 of its largest; in float64 by
  4e-15);
* the optimisers: the schedules within 1e-6 relative of optax's at every
  count (both evaluate in float32, in another order: 3e-7 measured); 4
  updates from the shipped weights, fed the same gradients, within 1e-6
  of the largest parameter step plus 1e-6 relative (float32 Adam);
* the data generators: RAFT's textures within 1e-6 and flows exactly,
  the warped view within 1e-5; the correspondences exactly; a DepthNet
  scene at 64 x 64 through the port's rasterizer (the kernels' exact
  path) and JAX's (the tiles path, budget 1024: no tile may hold more
  entries) with JAX's surfel rotations: the depth and colour within 1e-4
  except at pixels where a splat sits at the 1/255 alpha cut of one
  rasterizer and not the other (at most 0.5% of the pixels);
* the weights files: the key set, shapes, dtypes and compression of the
  shipped files, readable both ways with equal outputs.
"""

import importlib
import os
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_parity import assert_close, assert_close_to_max, n, t
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.preprocess import depthnet as tdn
from vidu4d_tpu_torch.preprocess import featnet as tfn
from vidu4d_tpu_torch.preprocess import raft as traft
from vidu4d_tpu_torch.preprocess import train_common as tc
from vidu4d_tpu_torch.preprocess import train_depthnet as tdepth
from vidu4d_tpu_torch.preprocess import train_featnet as tfeat
from vidu4d_tpu_torch.preprocess import train_raft as traftt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "vidu4d_tpu", "weights")
SHIPPED = {"depthnet": "depthnet_synthetic.npz", "featnet": "featnet_synthetic.npz",
           "raft": "raft_small_synthetic.npz"}


@pytest.fixture(scope="module")
def scripts():
    """The JAX training scripts as modules (they import each other by
    name from scripts/)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return {name: importlib.import_module(name)
                for name in ("train_raft", "train_featnet", "train_depthnet")}
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


def _port_net(name):
    load = {"depthnet": tdn.load_depthnet, "featnet": tfn.load_featnet,
            "raft": traft.load_raft}[name]
    return load(os.path.join(WEIGHTS, SHIPPED[name]), device="cpu").train()


def _jax_params(name, path=None):
    from vidu4d_tpu.preprocess import depthnet as jdn
    from vidu4d_tpu.preprocess import featnet as jfn
    from vidu4d_tpu.preprocess import raft as jraft

    load = {"depthnet": jdn.load_weights, "featnet": jfn.load_weights,
            "raft": jraft.load_weights}[name]
    return load(path or os.path.join(WEIGHTS, SHIPPED[name]))


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads_flat(model):
    """``model``'s gradients (in their dtype) in the flax layout of JAX's
    trees ("params" root; conv kernels HWIO)."""
    flat = convert.flax_conv_net_flat(model, "params/")
    grads = dict(model.named_parameters())
    out = {}
    for fk, pk in zip(flat, convert.flax_conv_net_state_dict(model, flat)):
        g = grads[pk].grad.detach().numpy()
        out[fk] = g.transpose(2, 3, 1, 0) if fk.endswith("kernel") else g
    return out


def _loss_inputs(seed=0, b=2, h=32, w=24):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.1, 2.0, (b, h, w)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (b, h, w)).astype(np.float32)
    mask = (rng.uniform(size=(b, h, w)) > 0.2).astype(np.float32)
    return pred, depth, mask


def test_depth_losses_match_jax():
    """align_affine, ssi_mae, gradient_loss, depth_loss and ranking_loss with
    the pairs JAX draws from its key; the gradients of their weighted sum
    with respect to the prediction."""
    from vidu4d_tpu.preprocess import depthnet as jdn

    pred, depth, mask = _loss_inputs()
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    hw = pred.shape[1] * pred.shape[2]
    ii = np.asarray(jax.random.randint(k1, (2, 768), 0, hw))
    jj = np.asarray(jax.random.randint(k2, (2, 768), 0, hw))
    gt_disp = 1.0 / depth
    for jfn_, tfn_ in ((jdn.ssi_mae, tdn.ssi_mae), (jdn.gradient_loss, tdn.gradient_loss)):
        assert_close(jfn_(pred, gt_disp, mask), tfn_(t(pred), t(gt_disp), t(mask)), 0, 1e-5)
    for a, b in zip(jdn.align_affine(pred, gt_disp, mask),
                    tdn.align_affine(t(pred), t(gt_disp), t(mask))):
        assert_close(a, b, 0, 1e-5)
    # a singular system (a constant prediction) falls back to s = 1
    s, _ = tdn.align_affine(torch.ones(1, 4, 4), t(gt_disp[:1, :4, :4]), torch.ones(1, 4, 4))
    assert float(s[0]) == 1.0

    def jtotal(p):
        return (jdn.depth_loss(p, depth, mask)
                + 0.7 * jdn.ranking_loss(p, depth, mask, key))

    ref, jgrad = jax.jit(jax.value_and_grad(jtotal))(jnp.asarray(pred))
    tp = t(pred, requires_grad=True)
    got = (tdn.depth_loss(tp, t(depth), t(mask))
           + 0.7 * tdn.ranking_loss(tp, t(depth), t(mask), torch.as_tensor(ii),
                                    torch.as_tensor(jj)))
    got.backward()
    assert_close(ref, got, 0, 1e-5)
    assert_close_to_max(jgrad, tp.grad, 1e-4)
    assert_close(jdn.ranking_loss(pred, depth, mask, key),
                 tdn.ranking_loss(t(pred), t(depth), t(mask), torch.as_tensor(ii),
                                  torch.as_tensor(jj)), 0, 1e-5)
    ii2, jj2 = tdn.ranking_pairs(2, hw, torch.Generator().manual_seed(0))
    assert ii2.shape == jj2.shape == (2, 768) and int(ii2.max()) < hw


def test_featnet_losses_match_jax():
    """info_nce_pair (value and gradients of both feature maps) and
    match_accuracy on random unit features."""
    from vidu4d_tpu.preprocess import featnet as jfn

    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(16, 16, 8)).astype(np.float32)
    f2 = (f1 + 0.3 * rng.normal(size=f1.shape)).astype(np.float32)
    xy1 = rng.uniform(2, 29, (40, 2)).astype(np.float32)
    xy2 = (xy1 + rng.normal(0, 0.5, xy1.shape)).astype(np.float32)
    ref, (g1, g2) = jax.value_and_grad(jfn.info_nce_pair, argnums=(0, 1))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(xy1), jnp.asarray(xy2))
    a, b = t(f1, requires_grad=True), t(f2, requires_grad=True)
    got = tfn.info_nce_pair(a, b, t(xy1), t(xy2))
    got.backward()
    assert_close(ref, got, 0, 1e-5)
    assert_close_to_max(g1, a.grad, 1e-4)
    assert_close_to_max(g2, b.grad, 1e-4)
    acc = jfn.match_accuracy(jnp.asarray(f1), jnp.asarray(f2), xy1, xy2)
    assert 0 < acc < 1
    assert tfn.match_accuracy(t(f1), t(f2), xy1, xy2) == acc


def test_raft_sequence_loss_matches_jax(scripts):
    """The gamma-weighted L1 over RAFT's 12 iterations and the last EPE on a
    32 x 32 pair of make_batch, from the shipped weights."""
    from vidu4d_tpu.preprocess import raft as jraft

    img1, img2, gt = scripts["train_raft"].make_batch(np.random.default_rng(3), 32, 1)
    preds = jax.jit(lambda p: jraft.RaftSmall().apply(p, img1, img2, all_iters=True))(
        _jax_params("raft"))
    ref = sum(0.8 ** (len(preds) - i - 1) * jnp.mean(jnp.abs(fl - gt))
              for i, fl in enumerate(preds))
    ref_epe = jnp.mean(jnp.linalg.norm(preds[-1] - gt, axis=-1))
    model = _port_net("raft")
    with torch.no_grad():
        out = model(t(img1).permute(0, 3, 1, 2), t(img2).permute(0, 3, 1, 2), all_iters=True)
        loss, epe = traft.sequence_loss(out, t(gt))
    assert len(out) == 12
    assert_close(ref, loss, 0, 1e-4)
    assert_close(ref_epe, epe, 0, 1e-4)


@pytest.mark.parametrize("count", [3, 4, 10, 17, 100])
def test_schedules_match_optax(count):
    """linear_onecycle_schedule (NaN where optax's is: fewer than 4 steps)
    and warmup_cosine_decay_schedule at every count up to past the end."""
    ref = optax.linear_onecycle_schedule(count, 2e-4)
    got = tc.linear_onecycle_schedule(count, 2e-4)
    for c in range(count + 3):
        a, b = float(ref(c)), got(c)
        if np.isnan(a):
            assert np.isnan(b), c
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-30, err_msg=str(c))
    warmup = min(100, max(1, count // 10))
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(count, warmup + 1))
    got = tc.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(count, warmup + 1))
    for c in range(count + 3):
        np.testing.assert_allclose(got(c), float(ref(c)), rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("name", ["depthnet", "featnet", "raft"])
def test_optimiser_steps_match_optax(name):
    """The trainers' optimisers (depthnet / raft: clip_by_global_norm(1) +
    adamw(onecycle); featnet: adamw(warmup cosine, 1e-5)) over 4 updates of
    the shipped weights with the same random gradients (some above the clip
    norm, some below): every parameter after each update."""
    model = _port_net(name)
    jparams = _jax_params(name)
    steps, lr = 12, 3e-4
    make = {"depthnet": tdepth.make_optimizer, "featnet": tfeat.make_optimizer,
            "raft": traftt.make_optimizer}[name]
    opt = make(model, steps, lr)
    if name == "featnet":
        warmup = min(100, max(1, steps // 10))
        jopt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps),
                           weight_decay=1e-5)
    else:
        jopt = optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(optax.linear_onecycle_schedule(steps, lr)))
    state = jopt.init(jparams)
    update = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *jopt.update(g, st, p)))
    rng = np.random.default_rng(5)
    # JAX's trees of all three nets have a "params" root
    names = dict(zip(convert.flax_conv_net_flat(model, "params/"),
                     [k for k, _ in model.named_parameters()]))
    for scale in (0.3, 3e-4, 1.0, 3e-3):
        leaves, tdef = jax.tree_util.tree_flatten(jparams)
        grads = [rng.normal(size=x.shape).astype(np.float32) * scale / np.sqrt(x.size)
                 for x in leaves]
        jparams, state = update(jax.tree_util.tree_unflatten(tdef, grads), state, jparams)
        flat_g = _flat(jax.tree_util.tree_unflatten(tdef, grads))
        sd = convert.flax_conv_net_state_dict(model, flat_g)
        for k, p in model.named_parameters():
            p.grad = sd[k].clone()
        opt.step()
        ref = _flat(jparams)
        got = convert.flax_conv_net_flat(model, "params/")
        assert ref.keys() == got.keys()
        for k in ref:
            err = np.abs(got[k] - ref[k]).max()
            assert err <= 1e-6 * lr + 1e-6 * np.abs(ref[k]).max(), (k, err, names[k])
    assert opt.count == 4


@pytest.mark.parametrize("name", ["depthnet", "featnet"])
def test_train_step_gradients_match_jax(scripts, name):
    """The loss of one trainer step from the shipped weights on one batch of
    the trainer's own data at small size, and every parameter's gradient,
    in float64 (the JAX script's loss: depth_loss + ranking_loss with the
    pairs of its key; the mean over the pairs of the InfoNCE)."""
    from vidu4d_tpu.preprocess import depthnet as jdn
    from vidu4d_tpu.preprocess import featnet as jfn

    model = _port_net(name).double()
    rng = np.random.default_rng(2)
    f64 = lambda x: np.asarray(x, np.float64)
    d = lambda x: torch.as_tensor(f64(x))
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(f64(a)), _jax_params(name))
        if name == "depthnet":
            rgb = rng.uniform(size=(2, 32, 32, 3))
            dep = rng.uniform(0.5, 4.0, (2, 32, 32))
            val = np.ones_like(dep)
            key = jax.random.PRNGKey(7)
            k1, k2 = jax.random.split(key)
            ii = torch.as_tensor(np.asarray(jax.random.randint(k1, (2, 768), 0, 1024)))
            jj = torch.as_tensor(np.asarray(jax.random.randint(k2, (2, 768), 0, 1024)))

            def jloss(p):
                disp = jdn.DepthNet().apply(p, rgb)
                return jdn.depth_loss(disp, dep, val) + jdn.ranking_loss(disp, dep, val, key)

            disp = model(d(rgb).permute(0, 3, 1, 2))
            loss = (tdn.depth_loss(disp, d(dep), d(val))
                    + tdn.ranking_loss(disp, d(dep), d(val), ii, jj))
        else:
            img1, img2, flow = scripts["train_raft"].make_batch(rng, 64, 2)
            xy = [scripts["train_featnet"].sample_correspondences(rng, np.asarray(f), 64, 64)
                  for f in flow]
            img1, img2 = f64(img1), f64(img2)
            xy1, xy2 = f64([x[0] for x in xy]), f64([x[1] for x in xy])

            def jloss(p):
                return jnp.mean(jax.vmap(jfn.info_nce_pair)(
                    jfn.FeatNet().apply(p, img1), jfn.FeatNet().apply(p, img2), xy1, xy2))

            f1 = tfeat.hwc(model(d(img1).permute(0, 3, 1, 2)))
            f2 = tfeat.hwc(model(d(img2).permute(0, 3, 1, 2)))
            loss = torch.stack([tfn.info_nce_pair(f1[b], f2[b], d(xy1[b]), d(xy2[b]))
                                for b in range(2)]).mean()
        ref, grads = jax.jit(jax.value_and_grad(jloss))(params)
        ref_g = _flat(grads)
    loss.backward()
    assert_close(ref, loss, 0, 1e-10)
    got_g = _port_grads_flat(model)
    assert ref_g.keys() == got_g.keys()
    for k in ref_g:
        assert got_g[k].dtype == np.float64
        assert_close_to_max(ref_g[k], got_g[k], 1e-9, k)


def test_raft_data_generators_match_jax(scripts):
    """make_batch (textures, flows, the warped and jittered view) and
    sample_correspondences from the same numpy generator."""
    a = scripts["train_raft"].make_batch(np.random.default_rng(0), 32, 2)
    rng = np.random.default_rng(0)
    b = traftt.make_batch(rng, 32, 2)
    assert_close(a[0], b[0], 1e-6)
    assert np.array_equal(np.asarray(a[2]), n(b[2]))
    assert_close(a[1], b[1], 1e-5)
    flow = np.asarray(a[2][0])
    ref = scripts["train_featnet"].sample_correspondences(np.random.default_rng(9), flow, 50, 32)
    got = tfeat.sample_correspondences(np.random.default_rng(9), flow, 50, 32)
    assert all(np.array_equal(x, y) for x, y in zip(ref, got))


def test_depthnet_scene_matches_jax(scripts):
    """make_scene at 64 x 64 through both rasterizers, the JAX rotations
    carried across: no tile holds more than the JAX tiles path's budget of
    1024 entries (which would drop the rest), the depth and colour agree,
    and both generators end in the same state."""
    from vidu4d_tpu.models.gaussian import surfels as jsf
    from vidu4d_tpu_torch.ops.rasterize import common

    res = 64
    rot = torch.as_tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                                        (tdepth.SCENE_CAP, 4))))
    for seed in (0, 1):
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = scripts["train_depthnet"].make_scene(rng_j, res)
        splats = tdepth.scene_splats(np.random.default_rng(seed), res)
        got = tdepth.make_scene(rng_t, res, rot)
        assert rng_j.uniform() == rng_t.uniform()
        # the JAX init (KNN scales, which make_scene overrides) draws its
        # rotations from PRNGKey(0): the same as `rot`
        state = jsf.init_from_points(jnp.asarray(splats.xyz), jnp.asarray(splats.colors),
                                     capacity=tdepth.SCENE_CAP, sh_degree=0)
        assert np.array_equal(np.asarray(state.params.rotation), n(rot))
        quats = rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
        proj = common.project_splats(
            t(splats.xyz), quats, torch.exp(t(splats.scales_log))[:, None].expand(-1, 2),
            torch.eye(4), t(splats.intrins),
            mask=torch.arange(tdepth.SCENE_CAP) < splats.n)
        binning = common.bin_splats_aligned(proj, res, res)
        assert 0 < int(binning.tile_count.max()) <= 1024
        for k, (a, b) in enumerate(zip(ref[:2], got[:2])):
            diff = np.abs(np.asarray(a) - b)
            if diff.ndim == 3:
                diff = diff.max(-1)
            assert (diff > 1e-4).mean() <= 5e-3, (seed, k, (diff > 1e-4).mean())
        assert np.array_equal(np.asarray(ref[2]), got[2])


@pytest.mark.parametrize("name", ["depthnet", "featnet", "raft"])
def test_weights_files_read_both_ways(name, tmp_path):
    """The port's save_weights writes the shipped file's keys, shapes,
    dtypes and compression; JAX's load_weights reads it and its net gives
    the port's outputs; the file JAX's save_weights writes the port's
    loader reads, with the same outputs."""
    from vidu4d_tpu.preprocess import depthnet as jdn
    from vidu4d_tpu.preprocess import featnet as jfn
    from vidu4d_tpu.preprocess import raft as jraft

    model = _port_net(name).eval()
    with torch.no_grad():  # weights other than the shipped ones
        for p in model.parameters():
            p.mul_(1.01)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    if name == "raft":
        traft.save_weights(model, port_path)
    else:
        {"depthnet": tdn, "featnet": tfn}[name].save_weights(port_path, model)
    shipped = os.path.join(WEIGHTS, SHIPPED[name])
    with np.load(shipped) as a, np.load(port_path) as b:
        assert a.files == b.files
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a.files)
    with zipfile.ZipFile(shipped) as a, zipfile.ZipFile(port_path) as b:
        assert {i.compress_type for i in a.infolist()} == {i.compress_type for i in b.infolist()}
    jparams = _jax_params(name, port_path)
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    img2 = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    if name == "depthnet":
        japply = lambda p: jdn.DepthNet().apply(p, img)
        tapply = lambda m: m(t(img).permute(0, 3, 1, 2))
        jdn.save_weights(jax_path, jparams)
        back = tdn.load_depthnet(jax_path, device="cpu")
        tol = 1e-4
    elif name == "featnet":
        japply = lambda p: jfn.FeatNet().apply(p, img)
        tapply = lambda m: tfeat.hwc(m(t(img).permute(0, 3, 1, 2)))
        jfn.save_weights(jax_path, jparams)
        back = tfn.load_featnet(jax_path, device="cpu")
        tol = 1e-5
    else:
        japply = lambda p: jraft.RaftSmall().apply(p, img, img2)
        tapply = lambda m: m(t(img).permute(0, 3, 1, 2), t(img2).permute(0, 3, 1, 2))
        jraft.save_weights(jparams, jax_path)
        back = traft.load_raft(jax_path, device="cpu")
        tol = 2e-4
    with torch.no_grad():
        got = tapply(model)
        assert torch.equal(tapply(back), got)
    assert_close(japply(jparams), got, tol)
    sd = model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in back.state_dict().items())


@pytest.mark.parametrize("module", [traftt, tfeat, tdepth])
def test_default_out_is_outside_the_jax_package(module):
    """The trainers write under weights_out/ (ignored by git), never over
    the shipped weights that the loaders read."""
    out = os.path.realpath(module.parse_args([]).out)
    assert not out.startswith(os.path.realpath(os.path.join(REPO, "vidu4d_tpu")) + os.sep)
    assert out.startswith(os.path.realpath(tc.WEIGHTS_OUT) + os.sep)
    assert os.path.basename(out) in SHIPPED.values()
    assert module.parse_args([]).device == "cuda"


def test_trainers_run_end_to_end_on_the_cpu(tmp_path):
    """Each trainer's main at a small size on the CPU: finite losses, moved
    parameters, held-out scores, and a weights file (in a directory that
    does not exist yet; DepthNet's also written every 2 steps) the port's
    loader reads back to the trained net's outputs; the shipped files are
    untouched."""
    shipped = {k: open(os.path.join(WEIGHTS, v), "rb").read() for k, v in SHIPPED.items()}
    runs = {
        "raft": (traftt, ["--steps", "6", "--res", "32", "--batch", "2"]),
        "featnet": (tfeat, ["--steps", "6", "--res", "64", "--batch", "2", "--pts", "64"]),
        "depthnet": (tdepth, ["--steps", "6", "--res", "32", "--batch", "2", "--pool", "3",
                              "--width", "8", "--save_every", "2"]),
    }
    img = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    for name, (module, argv) in runs.items():
        path = str(tmp_path / name / f"{name}.npz")  # a directory main has to make
        out = module.main(argv + ["--device", "cpu", "--out", path])
        assert len(out["loss"]) == 6 and np.isfinite(out["loss"]).all(), name
        assert out["param_change"] > 0 and len(out["step_ms"]) == 6, name
        assert out["out"] == path
        assert {"raft": {"epe_raft", "epe_lk"},
                "featnet": {"match_acc_featnet", "match_acc_hog"},
                "depthnet": {"ssi_mae", "order_acc", "flow_parallax_order_acc"}}[name] <= set(out)
        with np.load(path) as f:
            assert len(f.files) == {"raft": 88, "featnet": 10, "depthnet": 74}[name]
    back = tdn.DepthNet(width=8)
    convert.load_flax_conv_net_(back, dict(np.load(str(tmp_path / "depthnet" / "depthnet.npz"))))
    assert torch.isfinite(back(img)).all()
    for k, v in SHIPPED.items():
        assert open(os.path.join(WEIGHTS, v), "rb").read() == shipped[k], k
