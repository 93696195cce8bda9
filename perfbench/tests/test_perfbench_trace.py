"""Reading a traced run: the device timeline's busy and idle time, kernel
time inside host spans, and the profiler's clock put on the host's."""
import time

import pytest
import torch

from harness import trace
from harness.trace import DeviceTrace, Span


def test_busy_idle_and_kernel_time_inside_spans():
    ops = [Span("limb_matmul_skinny_kernel", 1.0, 2.0), Span("splitk_reduce", 1.5, 2.5),
           Span("elementwise", 4.0, 5.0), Span("limb_matmul_dd_kernel", 6.0, 7.0)]
    dt = DeviceTrace(ops, [Span("bench.step", 0.5, 8.0)], 0.0, 10.0)
    assert dt.busy() == [(1.0, 2.5), (4.0, 5.0), (6.0, 7.0)]
    assert dt.busy_s() == pytest.approx(3.5)
    assert dt.idle_gaps() == [(0.0, 1.0), (2.5, 4.0), (5.0, 6.0), (7.0, 10.0)]
    spans = [Span("decode_step", 0.9, 3.0), Span("decode_step", 5.5, 7.5)]
    # the double-f32 kernel is not the limb kernel; the elementwise op falls outside
    assert dt.device_time(trace.is_limb_kernel, spans) == pytest.approx(2.0)
    brk = trace.breakdown(dt, spans)
    assert brk["device_ops"][0][1] == pytest.approx(1.0)
    # each gap goes whole to what the host did at its middle
    assert dict(brk["idle_gaps"]) == pytest.approx(
        {"bench.step/decode_step": 1.0, "bench.step": 1.0 + 1.5, "between ranges": 3.0})


def test_profiler_clock_is_put_on_the_host_clock():
    from torch.profiler import ProfilerActivity, profile

    starts = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            starts.append(time.perf_counter())
            with torch.profiler.record_function("bench.step"):
                time.sleep(0.02)
    dt = trace.from_profiler(prof, starts, starts[0], time.perf_counter())
    steps = [s for s in dt.host if s.name == "bench.step"]
    assert len(steps) == 3 and dt.ops == []
    for s, t in zip(sorted(steps, key=lambda s: s.t0), starts):
        assert abs(s.t0 - t) < 2e-3 and s.t1 - s.t0 == pytest.approx(0.02, abs=5e-3)


def test_the_profiler_records_every_step_of_the_window():
    from harness import drive, main

    drv = drive.Driver(None, None, None)
    prof = main.profiled(drv)
    t_open, steps = time.perf_counter(), []
    for _ in range(4):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            time.sleep(0.01)
        steps.append(drive.Step(t0, time.perf_counter(), [], [0]))
        drv.on_step(steps[-1])
    prof.__exit__(None, None, None)
    dt = trace.from_profiler(prof, drv.on_step.starts, t_open, time.perf_counter())
    assert drv.on_step.starts == [s.t0 for s in steps]
    got = sorted(s.t0 for s in dt.host if s.name == "bench.step")
    assert got == pytest.approx([s.t0 for s in steps], abs=2e-3)
