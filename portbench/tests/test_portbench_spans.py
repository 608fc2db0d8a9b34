"""`portbench.spans`: on a CPU trace of a toy einsum warp, with host time
standing in for device time, the warp's backward is the backward of the
nodes made inside the span and nothing else; on synthetic events, a
span's annotation is never a device operation; the window's host times by
hand."""

from types import SimpleNamespace

import torch
from torch.autograd import DeviceType

from portbench import spans
from vidu4d_tpu_torch.utils import profiler

OUTSIDE = {"MulBackward0", "SinBackward0", "PowBackward0", "SumBackward0",
           "torch::autograd::AccumulateGrad"}


def test_the_warps_backward_is_that_of_the_ops_inside():
    x = torch.randn(64, 8, 3, requires_grad=True)
    w = torch.randn(8, 3, 3, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a = x * 2
        with profiler.span("warp"):
            y = torch.einsum("nbi,bij->nbj", a, w)
        (y.sin() ** 2).sum().backward()
    events = prof.events()
    out = spans.device(events, op_us=lambda e: e.self_cpu_time_total)
    nodes = [e for e in events if e.name.startswith(spans.BACKWARD)]
    inside = [e for e in nodes if e.name[len(spans.BACKWARD):] not in OUTSIDE]
    assert "BmmBackward0" in out["warp_bwd_nodes"]
    assert not set(out["warp_bwd_nodes"]) & OUTSIDE
    assert sum(out["warp_bwd_nodes"].values()) == len(inside)
    want = sum(e.cpu_time_total for e in inside)
    assert abs(out["warp_bwd_us"] - want) <= 1e-6 * want
    (mark,) = [e for e in events if e.name == "vidu4d.warp"]
    want = mark.cpu_time_total - mark.self_cpu_time_total
    assert out["spans"]["warp"]["calls"] == 1
    assert abs(out["spans"]["warp"]["device_us"] - want) <= 1e-6 * want


def event(name, start, end, device=DeviceType.CPU, kernels=(), seq=-1):
    return SimpleNamespace(name=name, device_type=device, is_async=False, thread=1,
                           fwd_thread=0, sequence_nr=seq,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])


def test_an_annotation_is_never_a_device_operation():
    events = [event("vidu4d.warp", 0.0, 10.0, kernels=[("vidu4d.warp", 50.0)]),
              event("aten::bmm", 1.0, 2.0, kernels=[("gemm", 7.0)]),
              event("portbench.warp_fwd", 0.0, 10.0, kernels=[("portbench.warp_fwd", 9.0)]),
              event("vidu4d.warp", 1.0, 60.0, device=DeviceType.CUDA),
              event("gemm", 1.5, 8.5, device=DeviceType.CUDA),
              event("aten::add", 20.0, 21.0, kernels=[("add", 3.0)])]
    out = spans.device(events)
    assert out["spans"] == {"warp": {"device_us": 7.0, "calls": 1}}
    assert out["held_us"] == 7.0 and out["device_us"] == 10.0


def test_window_by_hand():
    ms = 1_000_000
    records = [("data.read", "data.batch", 1, 3), ("data.read", "data.batch", 3, 4),
               ("data.copy", "data.batch", 4, 5), ("data.batch", "s3.step", 0, 6),
               ("s3.backward", "s3.step", 6, 9), ("s3.step", None, 0, 10),
               ("data.read", "data.batch", 11, 12), ("data.copy", "data.batch", 12, 14),
               ("data.batch", "s3.step", 10, 14), ("s3.step", None, 10, 30),
               ("s3.hooks", None, 30, 31)]
    records = [(n, p, s * ms, t * ms) for n, p, s, t in records]
    out = spans.window(records)
    assert out["host_step_ms"] == (4 + 16) / 2
    assert out["batch_read_ms"] == (3 + 1) / 2
    assert out["batch_copy_ms"] == (1 + 2) / 2
    assert out["host_ms"]["s3.step"] == 30 and out["host_ms"]["s3.hooks"] == 1


def test_the_probe_reads_the_spans_on_a_small_cell():
    """`portbench/spans_probe.py` on the CPU at a test's size: the
    collector's windows read the host's times, and the profiled chunk holds
    one ``s3.step`` a step and no span on the device's timeline."""
    from portbench import spans_probe
    from portbench.tests.sizes import CELLS, SMALL

    torch.set_num_threads(2)
    cell = "s3-gs-bob.train"
    out = spans_probe.probe(cell, 2 ** 31 + 77, 0.01, rounds=1, device="cpu",
                            overrides=SMALL[CELLS[cell]])
    off, on, timed = out["windows"]
    assert [w["kind"] for w in out["windows"]] == ["off", "collect", "timers"]
    assert "host_step_ms" not in off
    assert on["host_step_ms"] > 0 and on["batch_read_ms"] > 0 and on["batch_copy_ms"] > 0
    assert timed["batch_ms"] >= timed["data_batch_ms"] > 0
    p = out["profile"]
    assert p["span_calls"]["s3.step"] == p["steps"]
    assert p["span_calls"]["data.read"] == 2 * p["steps"]
    assert p["span_events_on_device"] == 0 and p["clock"]["same_order"]
