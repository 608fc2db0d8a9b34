"""The port's Stage-2 step (`Stage2Trainer`, ``--fg_motion bob
--rgb_timefree --rgb_dirfree``, published widths, on the CPU) against the
benchmark's plain Stage-2 reference (`portbench/reference/stage2.py`),
which imports nothing of the port: every weighted loss term, every leaf's
gradient as AdamW takes it, and one AdamW update, from the same seeded
state on the same batch (4 pairs x 4 pixels of a 32^2, 8-frame
`portbench.database`) and the same regularisers' draws at step 2000; the
reference works out the step's annealed weights itself, and they are
checked against the port's schedule. A 1% brighter rendered colour,
planted in the port, fails the comparison."""

import ast
import os

import numpy as np
import pytest
import torch

from portbench import database
from portbench.reference import stage2 as ref2
from vidu4d_tpu_torch import config
from vidu4d_tpu_torch.engine import model as model_mod
from vidu4d_tpu_torch.engine.schedules import progress_schedule
from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState

RES, FRAMES, PAIRS, PIXELS, STEP, SEED = 32, 8, 4, 4, 2000, 4242
FLAGS = ["--fg_motion", "bob", "--num_rounds", "21", "--iters_per_round", "200",
         "--rgb_timefree", "--rgb_dirfree", "--imgs_per_gpu", str(PAIRS),
         "--pixels_per_image", str(PIXELS), "--train_res", str(RES)]
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "portbench", "reference", "stage2.py")

# float32 round-off of two orders of the same operations, on a loss of
# 15 terms of 2,048 samples: the two sides' weighted terms agree within
# 1.9e-7 relative (three seeds), so 1e-5 leaves 50x room
TERM_RTOL = 1e-5
# a leaf's gradient as AdamW takes it (NaN to 0, clipped to a global norm
# of 5), through the warp, the field, the renderer and the eikonal's double
# backward: elementwise within 8.5e-6 of the larger of the leaf's norm and
# the median leaf's (three seeds), so 1e-4 of it leaves 12x room
GRAD_RTOL = 1e-4
# one AdamW update, elementwise, against the leaf's change over the update:
# within 2.9e-5 of it (three seeds; warm second moments make the update ~lr
# x g / rms(g), so the gradient's round-off carries over), 1e-3 leaves 35x
STEP_RTOL = 1e-3


def trainer(tmp_path):
    db = database.write_database(str(tmp_path), SEED, RES, FRAMES, "cpu")
    opts = config.parse_flags(FLAGS)
    opts.pop("device", None)
    opts.update(dataroot=db, seqname=database.SEQ, seed=SEED,
                logroot=os.path.join(str(tmp_path), "logdir"))
    torch.manual_seed(0)
    return Stage2Trainer(opts, "cpu"), db


def build(tmp_path):
    """The port's trainer on the reference's seeded state at STEP (the
    parameters, the field's box and near / far, AdamW's moments and count),
    one batch and the step's draws."""
    tr, db = trainer(tmp_path)
    pixels = ref2.Pixels(db, database.SEQ, RES, "cpu")
    state = ref2.initial_state(FRAMES, RES, SEED, pixels, PAIRS, PIXELS, STEP)
    tr.model.load_state_dict({k: v.clone() for k, v in state["params"].items()})
    tr.states["fg"] = FieldState(aabb=state["field"]["aabb"].clone(),
                                 near_far=state["field"]["near_far"].clone(),
                                 proxy_pts=tr.states["fg"].proxy_pts)
    opt = tr.optimizer
    opt.count = STEP
    opt.mu = {k: state["moments"]["mu"][k].clone() for k in opt.params}
    opt.nu = {k: state["moments"]["nu"][k].clone() for k in opt.params}
    tr.current_steps = STEP
    batch = tr._next_batch()
    draws = tr.model.reg_draws(torch.Generator().manual_seed(STEP))
    return tr, state, pixels, batch, draws


def program_side(tr, batch, draws):
    """The port's weighted terms, its gradients as AdamW takes them (NaN to
    0, clipped) and its parameters after one update."""
    cfg = tr._loss_config()
    tr.model.zero_grad(set_to_none=True)
    terms, _ = tr.model.loss(batch, tr.states, cfg, progress_schedule(cfg, STEP), draws)
    sum(terms.values()).backward()
    params = dict(tr.model.named_parameters())
    raw = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
           for k, p in params.items()}
    raw = {k: torch.where(torch.isnan(g), 0.0, g) for k, g in raw.items()}
    norm = torch.sqrt(sum(torch.sum(g * g) for g in raw.values()))
    grads = {k: g / norm * 5.0 if norm >= 5.0 else g for k, g in raw.items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    tr.optimizer.step()
    after = {k: p.detach().clone() for k, p in params.items()}
    return ({k: float(v.detach()) for k, v in terms.items()}, grads, before, after)


def reference_side(state, pixels, batch, draws):
    ref_batch, gap = ref2.read_batch(pixels, batch)
    P = {ref2.short_name(k): v.clone() for k, v in state["params"].items()}
    field = {**state["field"], "camera_prior": pixels.camera_prior}
    Pg = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    _, terms = ref2.loss(Pg, field, ref_batch, STEP, draws, FRAMES, RES)
    _, grads = ref2.grads_at(P, field, ref_batch, STEP, draws, FRAMES, RES)
    mu = {ref2.short_name(k): v.clone() for k, v in state["moments"]["mu"].items()}
    nu = {ref2.short_name(k): v.clone() for k, v in state["moments"]["nu"].items()}
    after = dict(P)
    ref2.adamw(after, grads, mu, nu, STEP)
    name = ref2.program_name
    return ({k: float(v.detach()) for k, v in terms.items()},
            {name(k): v for k, v in grads.items()},
            {name(k): v for k, v in after.items()}, gap)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    torch.set_num_threads(2)
    tr, state, pixels, batch, draws = build(tmp_path_factory.mktemp("s2ref"))
    prog = program_side(tr, batch, draws)
    ref = reference_side(state, pixels, batch, draws)
    return prog, ref


def term_gaps(prog_terms, ref_terms):
    assert set(prog_terms) == set(ref_terms)
    return {k: abs(prog_terms[k] - ref_terms[k]) / max(abs(ref_terms[k]), 1e-30)
            for k in ref_terms if ref_terms[k] != 0.0 or prog_terms[k] != 0.0}


def test_batch_read_alike(sides):
    """The reference reads the port's frames and pixels from the database's
    files to the same values."""
    assert sides[1][3] == 0.0


def test_every_loss_term(sides):
    (prog_terms, *_), (ref_terms, *_) = sides
    gaps = term_gaps(prog_terms, ref_terms)
    assert len(prog_terms) == 15
    assert max(gaps.values()) <= TERM_RTOL, gaps


def test_every_leaf_gradient(sides):
    (_, prog_grads, _, _), (_, ref_grads, _, _) = sides
    assert set(prog_grads) == set(ref_grads)
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in ref_grads.items()}
    median = float(np.median(list(norms.values())))
    gaps = {k: float(torch.max(torch.abs(prog_grads[k] - g))) for k, g in ref_grads.items()}
    bad = {k: g for k, g in gaps.items() if g > GRAD_RTOL * max(norms[k], median)}
    assert not bad, bad


def test_one_adamw_update(sides):
    (_, _, before, prog_after), (_, _, ref_after, _) = sides
    bad = {}
    for k, p in prog_after.items():
        change = float(torch.linalg.vector_norm(ref_after[k] - before[k]))
        gap = float(torch.max(torch.abs(p - ref_after[k])))
        if gap > STEP_RTOL * change:
            bad[k] = (gap, change)
    assert not bad, bad


def test_brighter_colour_fails(tmp_path, monkeypatch):
    """The port with its rendered colour 1% brighter fails the loss terms'
    tolerance."""
    torch.set_num_threads(2)
    render = model_mod.render_pixel

    def brighter(*args, **kwargs):
        out = render(*args, **kwargs)
        return {**out, "rgb": out["rgb"] * 1.01}

    tr, state, pixels, batch, draws = build(tmp_path)
    monkeypatch.setattr(model_mod, "render_pixel", brighter)
    prog_terms = program_side(tr, batch, draws)[0]
    ref_terms = reference_side(state, pixels, batch, draws)[0]
    assert term_gaps(prog_terms, ref_terms)["rgb"] > TERM_RTOL


@pytest.mark.parametrize("step", [0, 400, 799, 800, 2000, 2001, 2002, 3999, 4000, 4200])
def test_reference_schedule_is_the_ports(tmp_path, step):
    """The reference's own annealed numbers at a step (the checked steps
    2000-2002 among them) are the port's schedule's, to the bit: both take
    the same float64 operations, and the weights scale float32 terms."""
    cfg = trainer(tmp_path)[0]._loss_config()
    prog = progress_schedule(cfg, step)
    ref = ref2.schedule(step)
    assert ref == {k: prog[k] for k in ref}, (ref, prog)


def test_reference_imports_neither_the_port_nor_jax():
    tops = set()
    for node in ast.walk(ast.parse(open(REFERENCE).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"vidu4d_tpu_torch", "vidu4d_tpu", "jax", "jaxlib", "flax"}, tops
    assert "vidu4d_tpu" not in open(REFERENCE).read()
