"""Stage-3 cells: `Stage3Trainer.train_one_round` of the program, in chunks
of the traffic's ``chunk`` steps, from ``start_step``.

Set-up: the database (`portbench.database`); the initial state, made by
the benchmark from the seed with the plain reference's code
(`portbench.reference`): the deformer's parameters, pixel-true intrinsics,
the identity camera, a cloud of ``gs_init_samples`` placed through the warp
onto the object, its colours and features, in ``gs_capacity`` slots, and
both optimisers' moments as a run that has trained a while holds them; the
program's trainer built from the configuration's flags, handed that state,
its step counter at ``start_step`` and both optimisers' counts at
``optimizer_count``; then the first chunk, which takes the checked steps,
the hooks after them and every shape the window uses. After the window
the plain reference takes the same steps from the same state on the frame
pairs the program's batches named (`reference`).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import math
import time
from types import SimpleNamespace
from typing import Dict

import torch

from portbench import compare, database, scene
from portbench.drivers import common
from portbench.reference import nets
from portbench.reference import stage3 as ref3

K1_ARGS = ("slab", "tile_start", "tile_count", "bg", "tiles_x", "tiles_per_frame", "n_extra",
           "tile")
KERNEL_REPS = 10
SURFEL_FIELDS = ref3.SURFEL_FIELDS
STATS = ("alive", "max_radii2d", "grad_accum", "denom")


def _pkg():
    """The program's modules that a Stage-3 run uses."""
    mods = {k: importlib.import_module(f"vidu4d_tpu_torch.{m}") for k, m in (
        ("trainer", "engine.gs4d_trainer"), ("sf", "models.gaussian.surfels"),
        ("tb", "ops.rasterize.tile_backward"), ("config", "config"),
        ("opt", "models.gaussian.optimizer"))}
    return type("Pkg", (), mods)


def step_of(run) -> ref3.Step:
    return ref3.Step(run.frames, run.res, run.opts["gs_capacity"], run.device)


def initial_state(run) -> Dict:
    """The benchmark's initial state, on the host: {"deformer": {name:
    tensor}, "surfels": {field or statistic: tensor}, "moments":
    {"deformer" | "surfels": {"mu" | "nu": {name: tensor}}}}."""
    dev = torch.device(run.device)
    n, cap = run.opts["gs_init_samples"], run.opts["gs_capacity"]
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    P = nets.init(run.frames, gen, dev)
    prior = torch.as_tensor(database.intrinsics_prior(run.res, run.frames)[0], device=dev)
    P["intrinsics.base_logfocal"][0] = torch.log(prior[:2])
    P["intrinsics.base_ppoint"][0] = prior[2:]
    scene.identity_camera(P)
    step = step_of(run)
    db = ref3.Database(run.db, database.SEQ, run.res, dev)
    first = db.batch(0, 1)
    scale = torch.tensor([0.03, 0.04, 0.03], device=dev)
    pts = (torch.randn((n, 3), generator=gen, device=dev) * scale).cpu().numpy()
    to_cam = lambda x: step.camera_points(P, torch.as_tensor(x, device=dev),
                                          first["frameid"], first["crop2raw"]).cpu().numpy()
    pts = scene.calibrate(to_cam, pts, scene.scene_target(n))
    cols = torch.rand((n, 3), generator=gen, device=dev)
    feats = torch.randn((n, 16), generator=gen, device=dev)
    feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    S = ref3.surfels(torch.as_tensor(pts, device=dev), cols, feats, cap, gen)
    moments = ref3.warm_moments(step, P, S, first, run.start)
    host = lambda t: t.detach().to("cpu", copy=True)
    tree = lambda d: {k: tree(v) if isinstance(v, dict) else host(v) for k, v in d.items()}
    out = tree({"deformer": P, "surfels": S, "moments": moments})
    del P, S, moments
    common.empty_cache(dev)
    return out


def install(pkg, trainer, state: Dict, start: int, count: int) -> None:
    """Hand the benchmark's initial state to the program's trainer."""
    dev = trainer.device
    copy = lambda t: t.to(dev, copy=True)
    trainer.deformer.load_state_dict({k: copy(v) for k, v in state["deformer"].items()})
    s = state["surfels"]
    params = pkg.sf.SurfelParams(**{f: copy(s[f]).requires_grad_(True) for f in SURFEL_FIELDS})
    trainer.set_surfels(pkg.sf.SurfelState(params, *(copy(s[f]) for f in STATS)))
    ms = state["moments"]["surfels"]
    trainer.gs_adam = trainer.gs_adam._replace(
        count=count, mu=pkg.sf.SurfelParams(**{f: copy(ms["mu"][f]) for f in SURFEL_FIELDS}),
        nu=pkg.sf.SurfelParams(**{f: copy(ms["nu"][f]) for f in SURFEL_FIELDS}))
    md = state["moments"]["deformer"]
    trainer.warp_opt.count = count
    trainer.warp_opt.mu = {k: copy(md["mu"][k]) for k in trainer.warp_opt.params}
    trainer.warp_opt.nu = {k: copy(md["nu"][k]) for k in trainer.warp_opt.params}
    trainer.current_steps = start


def _capture(trainer, state: Dict) -> compare.Capture:
    def leaves():
        sp = trainer.surfels.params
        out = {f"surfels.{f}": getattr(sp, f) for f in SURFEL_FIELDS}
        out.update({f"deformer.{k}": p for k, p in trainer.deformer.named_parameters()})
        return out

    def moments():
        out = {f"surfels.{f}": getattr(trainer.gs_adam.mu, f) for f in SURFEL_FIELDS}
        out.update({f"deformer.{k}": m for k, m in trainer.warp_opt.mu.items()})
        return out

    initial = {f"surfels.{f}": state["surfels"][f] for f in SURFEL_FIELDS}
    initial.update({f"deformer.{k}": v for k, v in state["deformer"].items()})
    return compare.Capture(trainer, leaves, moments, initial)


class Session(common.Session):
    """The program's trainer through set-up, the window and the traced
    steps."""

    def __init__(self, run):
        super().__init__(run)
        self.state = initial_state(run)
        self.pkg = _pkg()
        opts = common.trainer_opts(self.pkg, run)
        self.trainer = self.pkg.trainer.Stage3Trainer(opts, run.device)
        # the schedule's length is the configuration's rounds x iters; a call, a chunk
        self.trainer.opts["iters_per_round"] = run.chunk
        install(self.pkg, self.trainer, self.state, run.start, run.opt_count)
        self.capture = _capture(self.trainer, self.state)
        self.undo = common.plant(run.fault, self.pkg, self.trainer)
        self._last_batch = None
        self.batches = []  # the checked steps' batches, as the program read them
        self._orig_next = self.trainer._next_batch
        self.trainer._next_batch = self._next_batch
        for _ in range(run.warmup_chunks):
            self.chunk()
        self.capture.take_change()  # a warm-up no longer than the checked steps
        self.capture.close()

    def _next_batch(self):
        self._last_batch = self._orig_next()
        if len(self.batches) < compare.CHECKED_STEPS:
            self.batches.append({k: v.detach().clone() for k, v in self._last_batch.items()})
        return self._last_batch

    def chunk(self) -> int:
        m = self.trainer.train_one_round()
        self.nonfinite = self.nonfinite + (~torch.isfinite(m["total"])).to(torch.int64)
        return self.run.chunk

    @torch.no_grad()
    def probe(self) -> Dict:
        """Binned entries of the last batch's frames and alive surfels,
        for the state as it stands (outside any window)."""
        prepared, _ = self.trainer.render_inputs(self._last_batch)
        counts = prepared["tile_count"].reshape(-1, prepared["tiles_per_frame"])
        return {"entries_per_frame": counts.sum(1).tolist(),
                "alive": int(self.trainer.surfels.num_alive()),
                "step": self.trainer.current_steps}

    @contextlib.contextmanager
    def window_timers(self, rec: Dict):
        """Host ms around each batch read; each hook firing synchronised
        on both sides and timed (the traced run only)."""
        tr = self.trainer
        rec.setdefault("batch_s", []); rec.setdefault("hook_s", 0.0); rec["hooks"] = []
        inner_next, orig_hooks = tr._next_batch, tr._densify_hooks
        first = len(tr.hook_log)

        def timed_next():
            t0 = time.perf_counter()
            out = inner_next()
            rec["batch_s"].append(time.perf_counter() - t0)
            return out

        def timed_hooks(*a, **k):
            common.sync(tr.device)
            t0 = time.perf_counter()
            out = orig_hooks(*a, **k)
            common.sync(tr.device)
            rec["hook_s"] += time.perf_counter() - t0
            return out

        tr._next_batch, tr._densify_hooks = timed_next, timed_hooks
        try:
            yield
        finally:
            tr._next_batch = inner_next
            del tr.__dict__["_densify_hooks"]
            rec["hooks"] = [(e["hook"], e["step"]) for e in tr.hook_log[first:]]

    @contextlib.contextmanager
    def profile_ranges(self, rec: Dict):
        """`record_function` ranges around the batch read, the hooks, the
        step's forward, the warps and the optimisers; the inputs of the
        first ``SAMPLED_CALLS`` calls of each tile entry point kept for
        their bounds and times."""
        tr, pkg = self.trainer, self.pkg
        rng = common.ranged
        rec["kernel_inputs"] = []
        saved = []

        def patch(obj, name, fn):
            saved.append((obj, name, obj.__dict__.get(name, common.MISSING)))
            setattr(obj, name, fn)

        patch(tr, "_next_batch", rng("batch", tr._next_batch))
        patch(tr, "_densify_hooks", rng("hooks", tr._densify_hooks))
        patch(tr, "loss", rng("fwd", tr.loss))
        for name in ("warp_surfels", "flow_surfels", "cycle_loss"):
            patch(tr.deformer, name, rng("warp_fwd", getattr(tr.deformer, name)))
        patch(pkg.trainer, "gs_adam_update", rng("opt", pkg.trainer.gs_adam_update))
        patch(tr.warp_opt, "step", rng("opt", tr.warp_opt.step))
        fwd, bwd = pkg.tb.forward_tiles, pkg.tb.backward_tiles
        rec["k2_inputs"] = []
        keep = lambda x: x.detach().clone() if torch.is_tensor(x) else x

        def k1(*args):
            if len(rec["kernel_inputs"]) < common.SAMPLED_CALLS:
                rec["kernel_inputs"].append(dict(zip(K1_ARGS, map(keep, args))))
            return fwd(*args)

        def k2(*args):
            if len(rec["k2_inputs"]) < common.SAMPLED_CALLS:
                rec["k2_inputs"].append(tuple(map(keep, args)))
            return bwd(*args)

        patch(pkg.tb, "forward_tiles", k1)
        patch(pkg.tb, "backward_tiles", k2)
        try:
            yield
        finally:
            common.unpatch(saved)

    def kernel_ms(self, rec: Dict) -> Dict:
        """Device ms of each sampled call of the two tile entry points
        (`tile_forward.forward_tiles`, `tile_backward.backward_tiles`,
        whatever implements them) on its own inputs, by CUDA events around
        ``KERNEL_REPS`` calls in a row after a warm-up."""
        fwd, bwd = self.pkg.tb.forward_tiles, self.pkg.tb.backward_tiles
        out = {"k1": [], "k2": []}
        for name, fn, calls in (("k1", fwd, [tuple(b[k] for k in K1_ARGS)
                                             for b in rec.get("kernel_inputs", [])]),
                                ("k2", bwd, rec.get("k2_inputs", []))):
            for args in calls:
                out[name].append(common.cuda_ms(lambda: fn(*args), KERNEL_REPS))
        rec.pop("k2_inputs", None)
        return out

    def readings(self) -> Dict:
        out = self.capture.readings()
        out["batches"] = [{k: v.cpu() for k, v in b.items()} for b in self.batches]
        last = self.run.start + compare.CHECKED_STEPS
        fired = [e for e in self.trainer.hook_log if e["hook"] == "densify" and e["step"] == last]
        out["densify"] = {} if not fired else {
            k: int(fired[0][k]) for k in ("cloned", "split", "pruned", "alive")}
        return out

    def release(self) -> None:
        self.undo()
        del self.trainer, self.capture, self.batches, self._last_batch
        common.empty_cache(self.run.device)


def reference(run, state: Dict, prog: Dict, flops: bool = False) -> Dict:
    """The plain reference's checked steps from ``state`` on the frame
    pairs of the program's batches (``prog["batches"]``), and ``batch_gap``:
    the largest difference between each program batch and the same pair
    read from the database here (infinite where the program's pair is not
    one the loader can draw). With ``flops``, its first step's matrix
    FLOPs (the compositor left out)."""
    from portbench import bounds

    db = ref3.Database(run.db, database.SEQ, run.res, run.device)
    pairs, gap = [], 0.0
    for b in prog["batches"]:
        f = [int(x) for x in b["frameid"].reshape(-1)]
        pair = (f[0], f[1])
        if len(f) != 2 or not db.pair_ok(*pair):
            gap = math.inf
            pair = (f[0], f[0] + 1)
        else:
            gap = max(gap, ref3.batch_gap(b, db.batch(*pair)))
        pairs.append(pair)
    counter = bounds.MatmulFlops() if flops else None
    out = ref3.replay(step_of(run), db, state, pairs, run.start, run.opt_count,
                      compare.CHECKED_STEPS, run.ref_fault, counter)
    out["batch_gap"] = gap
    out["densify_gap"] = densify_check(run, out.pop("before_hooks"), out.pop("after_hooks"),
                                       bool(out["densify"]))
    if counter is not None:
        out["matmul_flops"] = counter.flops
    return out


@torch.no_grad()
def densify_check(run, before: Dict, after: Dict, fired: bool) -> float:
    """The program's hooks (`Stage3Trainer._densify_hooks`, with the
    program's options and split noise) run on the reference's store as it
    stood before the last checked step's hooks, against what the
    reference's hooks left: the largest difference over the surfel leaves
    and their moments, infinite where the two leave different surfels
    alive. 0 where no hook fired."""
    if not fired:
        return 0.0
    pkg = _pkg()
    copy = lambda d: pkg.sf.SurfelParams(**{f: d[f].clone() for f in SURFEL_FIELDS})
    s = before["surfels"]
    ns = SimpleNamespace(opts=common.trainer_opts(pkg, run), device=torch.device(run.device),
                         current_steps=run.start + compare.CHECKED_STEPS, hook_log=[],
                         surfels=pkg.sf.SurfelState(copy(s), *(s[k].clone() for k in STATS)),
                         gs_adam=pkg.opt.GsAdamState(count=run.opt_count + compare.CHECKED_STEPS,
                                                     mu=copy(before["mu"]),
                                                     nu=copy(before["nu"])))
    ns._split_noise = functools.partial(pkg.trainer.Stage3Trainer._split_noise, ns)
    pkg.trainer.Stage3Trainer._densify_hooks(ns, span=1)
    if not torch.equal(ns.surfels.alive, after["surfels"]["alive"]):
        return math.inf
    gap = 0.0
    for f in SURFEL_FIELDS:
        for prog, ref in ((getattr(ns.surfels.params, f), after["surfels"][f]),
                          (getattr(ns.gs_adam.mu, f), after["mu"][f]),
                          (getattr(ns.gs_adam.nu, f), after["nu"][f])):
            gap = max(gap, float(torch.max(torch.abs(prog - ref))))
    return gap
