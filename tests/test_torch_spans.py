"""The port's spans (`vidu4d_tpu_torch.utils.profiler`) on a small Stage-3
trainer on the CPU: the span tree under `torch.profiler` and under a
collector, one clock for both, nothing done with tracing off, and the
step's outputs bitwise the same with tracing on and off."""

import os
import statistics

import pytest
import torch
from torch.autograd import DeviceType

from tests.helpers import make_fake_db
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
from vidu4d_tpu_torch.utils import profiler

RES = 16
# each span's parent, None at the top
TREE = {"s3.step": None, "data.batch": "s3.step", "data.read": "data.batch",
        "data.copy": "data.batch", "s3.forward": "s3.step", "warp": "s3.forward",
        "s3.raster_prep": "s3.forward", "s3.composite": "s3.forward",
        "s3.backward": "s3.step", "s3.stats": "s3.step", "s3.optim": "s3.step",
        "s3.hooks": None, "s3.densify": "s3.hooks", "s3.reset_opacity": "s3.hooks",
        "s3.outlier": "s3.hooks"}
STEPS = 3  # one train_step, then a round of two with every hook after its first


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return make_fake_db(tmp_path_factory.mktemp("spans"), num_vids=1, T=8, H=RES, W=RES)


def trainer(db, tmp_path):
    torch.manual_seed(0)
    opts = {"dataroot": db, "seqname": "toy", "logname": "spans",
            "logroot": os.path.join(str(tmp_path), "logdir"), "data_prefix": "crop",
            "train_res": RES, "pixels_per_image": -1, "imgs_per_gpu": 1,
            "fg_motion": "gs-bob", "gs_capacity": 256, "gs_init_samples": 192,
            "sh_degree": 1, "feat_reproj_px": 64, "iters_per_round": 2,
            "densify_from_iter": 0, "densification_interval": 2,
            "opacity_reset_interval": 2, "outlier_filtering_interval": 2}
    return Stage3Trainer(opts, "cpu")


def steps(tr):
    tr.train_step()
    tr.train_one_round()


@pytest.fixture(scope="module")
def profiled(db, tmp_path_factory):
    """(the trace's spans as (name, thread, start_ns, end_ns), collector
    records) of `steps` under a profiler and a collector."""
    tr = trainer(db, tmp_path_factory.mktemp("profiled"))
    with profiler.collect() as records, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        steps(tr)
    # the trace's events, in ns from the Unix epoch (a `prof.events()`
    # event's time_range is in µs from kineto_results.trace_start_ns())
    traced = [(e.name()[len(profiler.PREFIX):], e.start_thread_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiler.PREFIX) and e.device_type() == DeviceType.CPU]
    return sorted(traced, key=lambda r: r[2]), sorted(records, key=lambda r: r[2])


def traced_tree(traced):
    """(name, parent) of each traced span: the innermost span on the same
    thread that holds it."""
    out = []
    for name, thread, s, t in traced:
        holders = [r for r in traced if r[1] == thread and r[2] <= s and t <= r[3]
                   and (r[2], r[3]) != (s, t)]
        out.append((name, min(holders, key=lambda r: r[3] - r[2])[0] if holders else None))
    return out


@pytest.mark.parametrize("source", ["profiler", "collector"])
def test_span_tree(profiled, source):
    traced, records = profiled
    tree = (traced_tree(traced) if source == "profiler"
            else [(name, parent) for name, parent, _, _ in records])
    assert {name for name, _ in tree} == set(TREE)
    assert all(parent == TREE[name] for name, parent in tree), tree
    count = lambda n: sum(1 for name, _ in tree if name == n)
    assert count("s3.step") == STEPS and count("warp") == 3 * STEPS
    assert count("data.read") == 2 * count("data.batch") == 2 * STEPS
    assert count("s3.hooks") == 2 and count("s3.densify") == 1


def test_collector_and_profiler_share_a_clock(profiled):
    """Each span as the collector and the profiler saw it: the median gap
    of their starts, and of their ends, under 50 µs."""
    traced, records = profiled
    assert [r[0] for r in traced] == [r[0] for r in records]
    for i in (2, 3):
        gap = statistics.median(abs(a[i] - b[i]) for a, b in zip(traced, records))
        assert gap < 50e3, gap


def test_off_is_off(db, tmp_path, monkeypatch):
    """No profiler and no collector: no profiler range is made; a
    collector alone makes none either; under a profiler, one per span."""
    made = []
    real = profiler._range

    def counted(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiler, "_range", counted)
    tr = trainer(db, tmp_path)
    steps(tr)
    with profiler.collect() as records:
        steps(tr)
    assert made == [] and records
    with profiler.collect() as records, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.train_step()
    assert sorted(made) == sorted(profiler.PREFIX + name for name, *_ in records)


def test_spans_are_operator_ranges_not_annotations(db, tmp_path):
    """A span is traced as an operator (``cpu_op``), never as a user
    annotation: a card's trace repeats an annotation on the device's
    timeline, where it would count as a device operation."""
    import json

    tr = trainer(db, tmp_path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_step()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"]
                if str(e.get("name", "")).startswith(profiler.PREFIX)}
    assert cats == {"cpu_op"}


def test_outputs_bitwise_with_tracing_on_and_off(db, tmp_path):
    off, on = trainer(db, tmp_path), trainer(db, tmp_path)
    out_off = [off.train_step(), off.train_one_round()]
    with profiler.collect(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out_on = [on.train_step(), on.train_one_round()]
    for a, b in zip(out_off, out_on):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), a
    for a, b in zip(state(off), state(on)):
        assert torch.equal(a, b)


def state(tr):
    """Every tensor of the trainer's state."""
    out, todo = [], [tr.surfels, tr.gs_adam.mu, tr.gs_adam.nu,
                     list(tr.deformer.state_dict().values()),
                     list(tr.warp_opt.mu.values()), list(tr.warp_opt.nu.values())]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        else:
            todo.extend(x)
    return out


# --- Stage 2 -------------------------------------------------------------------

from vidu4d_tpu_torch.engine.trainer import Stage2Trainer  # noqa: E402

S2_TREE = {"s2.step": None, "data.batch": "s2.step", "data.read": "data.batch",
           "data.copy": "data.batch", "s2.forward": "s2.step", "warp": "s2.forward",
           "s2.field": "s2.forward", "s2.render": "s2.forward", "s2.reg": "s2.forward",
           "s2.backward": "s2.step", "s2.optim": "s2.step"}
S2_PAIRS, S2_PIXELS = 2, 4


def s2_trainer(db, tmp_path):
    torch.manual_seed(0)
    opts = {"dataroot": db, "seqname": "toy", "logname": "spans2",
            "logroot": os.path.join(str(tmp_path), "logdir"), "data_prefix": "crop",
            "train_res": RES, "pixels_per_image": S2_PIXELS, "imgs_per_gpu": S2_PAIRS,
            "fg_motion": "bob", "rgb_timefree": True, "rgb_dirfree": True,
            "num_rounds": 2, "iters_per_round": 2}
    tr = Stage2Trainer(opts, "cpu")
    tr.current_steps = 2000
    return tr


@pytest.fixture(scope="module")
def s2_profiled(db, tmp_path_factory):
    """(traced spans, collector records) of one Stage-2 `train_step`."""
    tr = s2_trainer(db, tmp_path_factory.mktemp("s2profiled"))
    with profiler.collect() as records, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_step()
    traced = [(e.name()[len(profiler.PREFIX):], e.start_thread_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiler.PREFIX) and e.device_type() == DeviceType.CPU]
    return sorted(traced, key=lambda r: r[2]), sorted(records, key=lambda r: r[2])


@pytest.mark.parametrize("source", ["profiler", "collector"])
def test_stage2_span_tree(s2_profiled, source):
    """One step: the batch from the frame store (one read, the host's
    draws turned into indices; one copy, the gathers), the forward with its
    four warps (the samples' backward warp, the flow's and the
    reprojection's forward warps, the cycle), two field blocks, two renders
    (the composite and the field's own), two regulariser blocks (the
    eikonal, the sampled regularisers), the backward and AdamW."""
    traced, records = s2_profiled
    tree = (traced_tree(traced) if source == "profiler"
            else [(name, parent) for name, parent, _, _ in records])
    assert {name for name, _ in tree} == set(S2_TREE)
    assert all(parent == S2_TREE[name] for name, parent in tree), tree
    count = lambda n: sum(1 for name, _ in tree if name == n)
    assert count("s2.step") == count("s2.forward") == count("s2.optim") == 1
    assert count("data.read") == count("data.copy") == 1 and count("warp") == 4
    assert count("s2.field") == count("s2.render") == count("s2.reg") == 2


def test_stage2_outputs_bitwise_with_tracing_on_and_off(db, tmp_path):
    off, on = s2_trainer(db, tmp_path), s2_trainer(db, tmp_path)
    out_off = off.train_step()
    with profiler.collect(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out_on = on.train_step()
    assert out_off.keys() == out_on.keys()
    assert all(torch.equal(out_off[k], out_on[k]) for k in out_off), out_off
    for a, b in zip([*off.model.state_dict().values(), *off.optimizer.mu.values(),
                     *off.optimizer.nu.values()],
                    [*on.model.state_dict().values(), *on.optimizer.mu.values(),
                     *on.optimizer.nu.values()]):
        assert torch.equal(a, b)
