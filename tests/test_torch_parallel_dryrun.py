"""The reduced dryrun steps of vidu4d_tpu_torch/parallel/sharding.py
(`build_stage3_train_step`, `build_stage2_train_step` and their synthetic
inputs) against the JAX package's at mesh=None, from the JAX inputs'
parameters (converted) and the same numpy batch; and the port's steps over
2 gloo ranks against its own at mesh=None.

Stage 3: 4 frames, 256 surfels, 16^2; JAX's tiles path with a per-tile
budget above every tile's entries (it composites them all, as the port's
compositor does). Stage 2: the JAX function's defaults (8 frames, 4 x 12
pixels, 32^2, a depth-2 width-32 field), JAX's reg_losses draws of the
step's PRNGKey(0).

Tolerances, port vs JAX (float32): Stage 3's losses within 1e-4 relative,
its Adam moments within 2e-3 of each field's max |.| (the two compositors
sum in another order: 1.05e-3 measured on one field); Stage 2's terms
within 1e-3 relative and its total 1e-4 (tests/test_torch_stage2.py's
bounds: the eikonal term differentiates the SDF through the 10-band
encoding at points that differ by float32 rounding, 8.9e-4 measured); the
parameters after the first Adam step within 2 x the learning rate (Adam's
first step is ~lr * g / |g|, which flips sign where g is rounding noise).
The "vis" term is held to 15%: it is a nonzero mean of the visibility
BCE weighted by the transmittance, and on this random field every ray is
opaque, so its count is the rays whose float32 transmittance has not
underflowed, which the two packages' products reach on other rays (9.2%
measured; the Stage-2 trainer tests start from a pretrained SDF, where it
holds to 1e-3). The Stage-2 gradient is held against JAX's in float64
(the JAX step under ``jax.enable_x64`` with its frame time in float64 and
its draws made in that mode; the port's step in float64 with those draws):
both Adam moments after the step within MOMENT64 (1e-4) of each tensor's
max |.| plus MOMENT64_FLOOR (1e-9) of the largest moment (the JAX model
keeps its camera prior and matching scores in float32 in that mode, and
the converter hands its moments over in float32: 3.2e-6 measured alone,
on a first-layer bias of the SDF; 1.5e-5 on the skinning Gaussians'
log-scales in a run under xdist -n 4 with other modules, cause not
traced; the warp's logibeta gets a gradient of -1.2e-277 in the port
and -0 in JAX, which the floor covers). Port over 2 ranks vs mesh=None: the losses within 1e-5
relative + 1e-9, moments within 1e-5 of their max |.|; parameters within
1e-5 of their max + 1e-6 for Stage 3, and within 2 x the learning rate for
Stage 2 (its gradients agree to the moment bound, but ~g / (|g| + eps)
moves a parameter by up to lr for a g near eps = 1e-8, where the summation
order shows: 9.4e-5 measured).
"""

import numpy as np
import pytest
import torch

from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.models.gaussian.optimizer import GsLearningRates, field_lrs, gs_adam_init
from vidu4d_tpu_torch.ops.rasterize import RasterizeConfig
from vidu4d_tpu_torch.parallel import sharding

N_FRAMES, N_SURFELS, RES = 4, 256, 16
MOMENT64, MOMENT64_FLOOR = 1e-4, 1e-9


def _close_to_max(ref, got, rel, floor=0.0):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    if ref.size:
        err = np.abs(ref - got).max()
        assert err <= rel * np.abs(ref).max() + floor, (err, np.abs(ref).max())


def _s3_inputs(jparams, jsurfels):
    """The port's synthetic Stage-3 inputs with the JAX inputs' deformer
    parameters and surfel store."""
    from vidu4d_tpu_torch.data.frame_info import FrameInfo

    deformer, _, batch = sharding.make_synthetic_stage3_inputs(
        FrameInfo.single_video(8), N_FRAMES, N_SURFELS, RES, device="cpu")
    # the JAX init never reaches the camera MLP: the batch gives the camera
    missing, unexpected = deformer.load_state_dict(convert.flax_to_state_dict(jparams),
                                                   strict=False)
    assert not unexpected and {k.split(".")[0] for k in missing} == {"camera_mlp"}
    return deformer, convert.surfel_state_from_jax(jsurfels, "cpu"), batch


def _s3_step(mesh, jparams, jsurfels):
    torch.set_num_threads(1)
    deformer, surfels, batch = _s3_inputs(jparams, jsurfels)
    step = sharding.build_stage3_train_step(deformer, RES, RasterizeConfig(), mesh=mesh)
    surfels, adam, metrics = step(surfels, gs_adam_init(surfels.params), batch)
    return ({k: float(v) for k, v in metrics.items()},
            [p.detach().clone() for p in surfels.params], list(adam.mu), list(adam.nu))


def _s2_step(mesh, jparams, draws):
    torch.set_num_threads(1)
    model, states, batch, config, weights = sharding.make_synthetic_stage2_inputs(
        device="cpu")
    model.load_state_dict(convert.dvr_state_dict_from_flax(jparams))
    step, init = sharding.build_stage2_train_step(model, states, config, weights, mesh=mesh)
    opt, total, loss_dict = step(init(), batch, draws)
    names = [k for k, _ in model.named_parameters()]
    return ({"total": float(total), **{k: float(v) for k, v in loss_dict.items()}},
            {k: p.detach().clone() for k, p in model.named_parameters()},
            dict(zip(names, opt["mu"])), dict(zip(names, opt["nu"])))


def _s2_step64(jparams, draws):
    """The port's Stage-2 dryrun step in float64 at mesh=None."""
    model, states, batch, config, weights = sharding.make_synthetic_stage2_inputs(
        device="cpu")
    model.load_state_dict(convert.dvr_state_dict_from_flax(jparams))
    model.double()
    states = {c: type(st)(*[x.double() for x in st]) for c, st in states.items()}
    f64 = lambda d: {k: v.double() if v.is_floating_point() else v for k, v in d.items()}
    step, init = sharding.build_stage2_train_step(model, states, config, weights)
    opt, _, _ = step(init(), f64(batch), f64(draws))
    names = [k for k, _ in model.named_parameters()]
    return dict(zip(names, opt["mu"])), dict(zip(names, opt["nu"]))


def _jax_stage2_step64(jparams):
    """JAX's Stage-2 dryrun step in float64 mode (its frame time in float64,
    `torch_parity.jax_time_code_in_default_float`) from the same
    parameters, and the reg_losses draws of PRNGKey(0) made in that mode."""
    import jax
    import jax.numpy as jnp
    from vidu4d_tpu.parallel import sharding as jsh

    from tests.torch_parity import jax_time_code_in_default_float

    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        jax_time_code_in_default_float(mp)
        model, _, states, jbatch, config, weights = jsh.make_synthetic_stage2_inputs()
        batch = {k: np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32
                 else np.asarray(v) for k, v in jbatch.items()}
        jstep, jinit = jsh.build_stage2_train_step(model, f64(states), config, weights)
        params = f64(jparams)
        key = jax.random.PRNGKey(0)
        _, opt, _, _ = jstep(params, jinit(params), batch, key)
        k_vis, k_gauss, _, k_inst = jax.random.split(key, 4)
        t = lambda a: torch.tensor(np.asarray(a))
        draws = {"vis": t(jax.random.uniform(k_vis, (512, 3))),
                 "inst": t(jax.random.randint(k_inst, (512,), 0, 1)).long(),
                 "gauss": t(jax.random.uniform(k_gauss, (2048, 3)))}
        moments = [convert.dvr_state_dict_from_flax(jax.tree.map(np.asarray, x))
                   for x in (opt[0].mu, opt[0].nu)]
    return moments, draws


def _dryruns(mesh, s3_args, s2_args):
    return _s3_step(mesh, *s3_args), _s2_step(mesh, *s2_args)


@pytest.fixture(scope="module")
def run():
    import jax
    from vidu4d_tpu.data.frame_info import FrameInfo
    from vidu4d_tpu.ops.rasterize import RasterizeConfig as JConfig
    from vidu4d_tpu.parallel import sharding as jsh

    from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init as jadam_init

    deformer, jparams3, jsurfels, jbatch3 = jsh.make_synthetic_stage3_inputs(
        FrameInfo.single_video(8), N_FRAMES, N_SURFELS, RES)

    jstep3 = jsh.build_stage3_train_step(deformer, RES, JConfig(impl="tiles", budget=2048))
    js3 = jstep3(jparams3, jsurfels, jadam_init(jsurfels.params),
                 {k: jax.numpy.asarray(v) for k, v in jbatch3.items()})
    np3 = lambda x: jax.tree.map(np.asarray, x)
    jparams3, jsurfels = np3(jparams3), np3(jsurfels)

    model, jparams2, states, jbatch2, config, weights = jsh.make_synthetic_stage2_inputs()
    jstep2, jinit2 = jsh.build_stage2_train_step(model, states, config, weights)
    key = jax.random.PRNGKey(0)
    js2 = jstep2(jparams2, jinit2(jparams2), jbatch2, key)
    k_vis, k_gauss, _, k_inst = jax.random.split(key, 4)
    t = lambda a: torch.tensor(np.asarray(a))
    draws = {"vis": t(jax.random.uniform(k_vis, (512, 3))),
             "inst": t(jax.random.randint(k_inst, (512,), 0, 1)).long(),
             "gauss": t(jax.random.uniform(k_gauss, (2048, 3)))}
    s3_args, s2_args = (jparams3, jsurfels), (np3(jparams2), draws)
    one = _dryruns(None, s3_args, s2_args)
    ranks = sharding.spawn(_dryruns, 2, args=(s3_args, s2_args), device="cpu")
    jmoments64, draws64 = _jax_stage2_step64(np3(jparams2))
    return {"jax3": np3(js3), "jax2": np3(js2), "jbatch3": jbatch3, "jbatch2": jbatch2,
            "one": one, "ranks": ranks, "jax2_64": jmoments64,
            "one64": _s2_step64(np3(jparams2), draws64)}


def test_synthetic_batches_match_jax(run):
    """The port's synthetic batches are the JAX functions' (same numpy
    draws)."""
    from vidu4d_tpu_torch.data.frame_info import FrameInfo

    _, _, b3 = sharding.make_synthetic_stage3_inputs(FrameInfo.single_video(8), N_FRAMES,
                                                     N_SURFELS, RES, device="cpu")
    _, _, b2, _, _ = sharding.make_synthetic_stage2_inputs(device="cpu")
    for got, want in ((b3, run["jbatch3"]), (b2, run["jbatch2"])):
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_stage3_dryrun_step_matches_jax(run):
    jsurf, jadam, jm = run["jax3"]
    metrics, params, mu, nu = run["one"][0]
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=1e-4, err_msg=k)
    assert metrics["rgb"] > 0 and metrics["cyc"] > 0
    lrs = field_lrs(GsLearningRates(), 1.0)
    for i, f in enumerate(sf.SurfelParams._fields):
        _close_to_max(getattr(jadam.mu, f), mu[i], 2e-3)
        _close_to_max(getattr(jadam.nu, f), nu[i], 2e-3)
        diff = np.abs(np.asarray(getattr(jsurf.params, f)) - params[i].numpy())
        assert diff.size == 0 or diff.max() <= 2 * float(lrs[i]) + 1e-7, f
    assert float(np.abs(np.asarray(jadam.mu.opacity)).max()) > 0


def test_stage2_dryrun_step_matches_jax(run):
    """The float32 step's terms and parameters against JAX's, and its
    gradient through the float64 step's Adam moments against JAX's."""
    jparams, _, jtotal, jld = run["jax2"]
    metrics, params, _, _ = run["one"][1]
    assert set(metrics) == set(jld) | {"total"}
    for k in jld:
        np.testing.assert_allclose(metrics[k], float(jld[k]), rtol=0.15 if k == "vis" else 1e-3,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(metrics["total"], float(jtotal), rtol=1e-4)
    want = convert.dvr_state_dict_from_flax(jparams)
    for k, p in params.items():
        diff = np.abs(want[k].numpy() - p.numpy())
        assert diff.max() <= 2 * 1e-3 + 1e-7, k
    # the Adam moments after the step, float64 in both packages
    refs = run["jax2_64"]
    floor = MOMENT64_FLOOR * max(float(np.abs(v.numpy()).max()) for r in refs for v in r.values())
    for name, ref, got in zip(("mu", "nu"), refs, run["one64"]):
        assert set(ref) == set(got) == set(params)
        for k in ref:
            assert got[k].dtype == torch.float64, k
            r, g = ref[k].numpy(), got[k].numpy()
            err = float(np.abs(r - g).max())
            assert err <= MOMENT64 * float(np.abs(r).max()) + floor, (name, k, err)
    assert float(np.abs(refs[0]["fields.fg.basefield.mlp.linear_final.bias"].numpy()).max()) > 0


def test_dryrun_steps_over_two_ranks_match_one_process(run):
    """Both dryrun steps over 2 gloo ranks (one pair each) equal the port's
    own at mesh=None."""
    (m3, p3, mu3, nu3), (m2, p2, mu2, nu2) = run["one"]
    for r, ((g3, q3, gmu3, gnu3), (g2, q2, gmu2, gnu2)) in enumerate(run["ranks"]):
        for ref, got in ((m3, g3), (m2, g2)):
            assert set(ref) == set(got)
            for k in ref:
                assert abs(ref[k] - got[k]) <= 1e-5 * abs(ref[k]) + 1e-9, (r, k)
        for ref, got in ((mu3, gmu3), (nu3, gnu3)):
            for a, b in zip(ref, got):
                _close_to_max(a, b, 1e-5)
        for ref, got in ((mu2, gmu2), (nu2, gnu2)):
            for k in ref:
                _close_to_max(ref[k], got[k], 1e-5)
        for a, b in zip(p3, q3):
            _close_to_max(a, b, 1e-5, 1e-6)
        for k in p2:
            _close_to_max(p2[k], q2[k], 0.0, 2 * 1e-3)
