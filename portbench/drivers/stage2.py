"""Stage-2 cells: `Stage2Trainer.train_one_round` of the program, in chunks
of the traffic's ``chunk`` steps, from ``start_step``.

Set-up: the database (`portbench.database`); the program's trainer built
from the configuration's flags; the initial state, made by the benchmark
from the seed with the plain reference's code (`portbench.reference.stage2`:
the field's and the deformer's parameters, pixel-true intrinsics, the
camera at the object, the field's box and near / far from the object, and
AdamW's moments as a run that has trained a while holds them), handed to
the trainer with its step counter at ``start_step`` and AdamW's count at
``optimizer_count``; then the first chunks, which take the checked steps
and every shape the window uses. Each step's batch is the trainer's own
(`PairBatcher` over the memory maps, sampled pixels). After the window the
plain reference takes the same steps from the same state on the frames and
pixels of the program's batches, read from the database by itself, with
the regularisers' points the program drew; the reference works out each
step's annealed weights itself.

The change compared is the first update's (`FirstUpdate`), not the three
checked steps': the skinning warp turns each bone's rotation into the
hemisphere of a sample's heaviest bone, so a sample at a tie between two
bones moves by a whole blend when round-off tips it, and any two float32
runs part by such tips. On an H100 (`portbench/witness_s2.py`, 6 seeds) a
float64 reference's blends differ from the float32 one's in 9-17 of a
step's 1,581,056 at the second step and 49-137 at the third, and their
changes over the three steps part by 8.6e-6 to 2.3e-5, more than the
program's from the float32 reference (2.1e-6 to 1.4e-5) and within 2x of a
1% brighter colour's least. Over the first update the program reads
1.3e-8 to 2.0e-8 from the float32 reference, the brighter colour 2.2e-5 or
more. Every step's loss is printed and not compared: the program's third
step reads up to 1.1e-4 from the reference, the brighter colour's from
5.3e-5.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import time
from typing import Dict

import torch

from portbench import compare, database
from portbench.drivers import common
from portbench.reference import stage2 as ref2


def _pkg():
    """The program's modules that a Stage-2 run uses."""
    mods = {k: importlib.import_module(f"vidu4d_tpu_torch.{m}") for k, m in (
        ("trainer", "engine.trainer"), ("model", "engine.model"), ("config", "config"),
        ("dyn", "models.fields.dyn_nerf"), ("profiler", "utils.profiler"))}
    return type("Pkg", (), mods)


class FirstUpdate(compare.Capture):
    """`compare.Capture` with the change taken as the second step finds it:
    the parameters' change over the first update; the change over all the
    checked steps kept as ``change_all``."""

    def __init__(self, trainer, leaves, moments, initial):
        super().__init__(trainer, leaves, moments, initial)
        self.start, self.change_all = initial, {}

    def _step(self, *args, **kwargs):
        if self.calls == 1:
            self.take_change()
        elif self.calls == compare.CHECKED_STEPS:
            with torch.no_grad():
                self.change_all = {
                    k: torch.linalg.vector_norm(p.double() - self.start[k].to(p.device).double())
                    for k, p in self.leaves().items()}
            self.start = None
        return super()._step(*args, **kwargs)

    def readings(self) -> Dict:
        return {**super().readings(),
                "change_all": {k: float(v) for k, v in self.change_all.items()}}


def install(pkg, trainer, state: Dict, start: int, count: int) -> None:
    """Hand the benchmark's initial state to the program's trainer."""
    dev = trainer.device
    copy = lambda t: t.to(dev, copy=True)
    trainer.model.load_state_dict({k: copy(v) for k, v in state["params"].items()})
    old = trainer.states["fg"]
    trainer.states["fg"] = pkg.dyn.FieldState(aabb=copy(state["field"]["aabb"]),
                                              near_far=copy(state["field"]["near_far"]),
                                              proxy_pts=old.proxy_pts)
    opt = trainer.optimizer
    opt.count = count
    opt.mu = {k: copy(state["moments"]["mu"][k]) for k in opt.params}
    opt.nu = {k: copy(state["moments"]["nu"][k]) for k in opt.params}
    trainer.current_steps = start


def plant(kind, pkg, trainer):
    """Break the Stage-2 step underneath ``trainer``: ``frozen_state``, a
    step that leaves its state unchanged (AdamW does nothing);
    ``half_batch``, the batch's second half replaced by its first after the
    check has read it, so that every mean is taken over half of it;
    ``altered``, the rendered colour made 1% brighter where the volume
    render produces it. Returns the undo."""
    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, obj.__dict__.get(name, common.MISSING)))
        setattr(obj, name, fn)

    if kind is None:
        pass
    elif kind == "frozen_state":
        patch(trainer.optimizer, "step", lambda: None)
    elif kind == "half_batch":
        nxt = trainer._next_batch

        def half():
            batch = nxt()
            h = batch["frameid"].shape[0] // 2
            return {k: torch.cat([v[:h], v[:h], v[2 * h:]]) if v.ndim else v
                    for k, v in batch.items()}
        patch(trainer, "_next_batch", half)
    elif kind == "altered":
        render = pkg.model.render_pixel

        def brighter(*args, **kwargs):
            out = render(*args, **kwargs)
            return {**out, "rgb": out["rgb"] * 1.01}
        patch(pkg.model, "render_pixel", brighter)
    else:
        raise ValueError(f"unknown fault {kind!r}; known: {common.FAULTS}")
    return lambda: common.unpatch(saved)


class Session(common.Session):
    """The program's trainer through set-up, the window and the traced
    steps."""

    def __init__(self, run):
        super().__init__(run)
        self.nonfinite = 0
        self.pkg = pkg = _pkg()
        opts = common.trainer_opts(pkg, run)
        self.trainer = tr = pkg.trainer.Stage2Trainer(opts, run.device)
        # the schedule's length is the configuration's rounds x iters; a call, a chunk
        tr.opts["iters_per_round"] = run.chunk
        db = ref2.Pixels(run.db, database.SEQ, run.res, run.device)
        self.state = ref2.initial_state(run.frames, run.res, run.seed, db,
                                        tr.opts["imgs_per_gpu"], tr.opts["pixels_per_image"],
                                        run.start)
        del db
        install(pkg, tr, self.state, run.start, run.opt_count)
        params = lambda: dict(tr.model.named_parameters())
        self.capture = FirstUpdate(tr, params, lambda: tr.optimizer.mu, self.state["params"])
        self.batches, self.draws, self._batch_s = [], [], None
        self._orig_next = tr._next_batch
        tr._next_batch = self._next_batch
        draws = tr.model.reg_draws

        def kept_draws(gen):
            out = draws(gen)
            if len(self.draws) < compare.CHECKED_STEPS:
                self.draws.append({k: v.detach().cpu() for k, v in out.items()})
            return out
        tr.model.reg_draws = kept_draws
        # planted over the batch's record: the check reads the batch the loader gave
        self.undo = plant(run.fault, pkg, tr)
        for _ in range(run.warmup_chunks):
            self.chunk()
        self.capture.take_change()  # a warm-up of one step
        self.capture.close()

    def _next_batch(self):
        t0 = time.perf_counter()
        batch = self._orig_next()
        if self._batch_s is not None:
            self._batch_s.append(time.perf_counter() - t0)
        if len(self.batches) < compare.CHECKED_STEPS:
            self.batches.append({k: v.detach().cpu() for k, v in batch.items()})
        return batch

    def chunk(self) -> int:
        total = self.trainer.train_one_round()
        self.nonfinite += not math.isfinite(total)
        return self.run.chunk

    def probe(self) -> Dict:
        """The step, and the rays and samples a step queries (the
        configuration's pairs x 2 x pixels, x the depth samples)."""
        o = self.trainer.opts
        rays = o["imgs_per_gpu"] * 2 * o["pixels_per_image"]
        return {"step": self.trainer.current_steps, "rays": rays,
                "samples": rays * ref2.RECIPE["depth_samples"]}

    @contextlib.contextmanager
    def window_timers(self, rec: Dict):
        """Host s of each batch read (``batch_s``), and the program's spans
        over the window, recorded by its collector (`utils.profiler.collect`,
        where the program has one) into ``spans_host``."""
        rec.setdefault("batch_s", [])
        self._batch_s = rec["batch_s"]
        collect = getattr(self.pkg.profiler, "collect", None)
        try:
            with collect() if collect else contextlib.nullcontext() as records:
                yield
            if collect:
                rec["spans_host"] = records
        finally:
            self._batch_s = None

    @contextlib.contextmanager
    def profile_ranges(self, rec: Dict):
        """`record_function` ranges around the step's forward (the model's
        loss), the skinning warp's calls (`SkinningWarp.forward`: the
        samples' backward warp, the flow's and the reprojection's forward
        warps, the cycle), the field's MLP queries (`query`, `visibility`,
        `features`: at the samples and at the regularisers' points) and
        AdamW's update."""
        tr = self.trainer
        rng = common.ranged
        saved = []

        def patch(obj, name, fn):
            saved.append((obj, name, obj.__dict__.get(name, common.MISSING)))
            setattr(obj, name, fn)

        field = tr.model.fields["fg"]
        patch(tr.model, "loss", rng("fwd", tr.model.loss))
        patch(field.warp, "forward", rng("warp_fwd", field.warp.forward))
        for name in ("query", "visibility", "features"):
            patch(field, name, rng("s2_field_fwd", getattr(field, name)))
        patch(tr.optimizer, "step", rng("opt", tr.optimizer.step))
        try:
            yield
        finally:
            common.unpatch(saved)

    def readings(self) -> Dict:
        out = self.capture.readings()
        out["batches"] = self.batches
        out["draws"] = self.draws
        out["densify"] = {}
        return out

    def release(self) -> None:
        self.undo()
        del self.trainer, self.capture, self.batches, self.draws
        common.empty_cache(self.run.device)


def reference(run, state: Dict, prog: Dict, flops: bool = False) -> Dict:
    """The plain reference's checked steps from ``state`` on the frames and
    pixels of the program's batches (``prog["batches"]``), read from the
    database here, with the program's draws; and ``batch_gap``:
    the largest difference between each program batch and the same frames
    and pixels read here (infinite where a pair is not one the loader can
    draw or a pixel lies off the image). With ``flops``, its first step's
    matrix FLOPs."""
    from portbench import bounds

    db = ref2.Pixels(run.db, database.SEQ, run.res, run.device)
    batches, gap = [], 0.0
    for b in prog["batches"]:
        ref, g = ref2.read_batch(db, b)
        batches.append(ref)
        gap = max(gap, g)
    counter = bounds.MatmulFlops() if flops else None
    out = ref2.replay(db, state, batches, prog["draws"], run.frames, run.res, run.start,
                      run.opt_count, compare.CHECKED_STEPS, run.ref_fault, counter)
    out["batch_gap"] = gap
    if counter is not None:
        out["matmul_flops"] = counter.flops
    return out
