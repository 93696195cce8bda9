"""The readings of the program's own spans (``harness/sites.py``) over
synthetic events whose numbers are known, and over a tiny traced cell on
the CPU (``spans.py``)."""
import pytest
from conftest import tiny_root

import spans
from harness import sites, spec
from harness.trace import DeviceTrace, Span
from repro_torch.obs import Event

T_OPEN, T_CLOSE = 10.0, 20.0


def step(t0, t1, device_ms, **sites_ms):
    return Event(ts=t1, step=0, kind="decode_step",
                 data={"t0": t0, "dur_ms": (t1 - t0) * 1e3, "span": int(t0 * 10), "parent": None,
                       "device_ms": device_ms, "sites_ms": sites_ms})


def prefill(t0, t1, scatter):
    return Event(ts=t1, step=0, kind="prefill",
                 data={"t0": t0, "dur_ms": (t1 - t0) * 1e3, "sites_ms": {"scatter": scatter}})


EVENTS = [
    step(5.0, 5.3, 900.0, attention=800.0, ffn=50.0, state=40.0),  # warm-up
    prefill(9.0, 9.2, 500.0),  # warm-up
    step(11.0, 11.3, 290.0, attention=200.0, ffn=20.0, state=30.0),
    prefill(11.5, 11.6, 40.0),
    step(12.0, 12.3, 300.0, attention=210.0, ffn=22.0, state=31.0),
    step(13.0, 13.3, 310.0, attention=220.0, ffn=24.0, state=32.0),
    prefill(14.0, 14.1, 60.0),
    step(19.9, 20.2, 999.0, attention=999.0, ffn=0.0, state=0.0),  # past the close
]


def test_medians_over_the_window_keep_out_warm_up():
    assert sites.replay_device_ms(EVENTS, T_OPEN, T_CLOSE) == 300.0
    assert sites.site_ms(EVENTS, "decode_step", "attention", T_OPEN, T_CLOSE) == 210.0
    assert sites.site_ms(EVENTS, "decode_step", "ffn", T_OPEN, T_CLOSE) == 22.0
    assert sites.site_ms(EVENTS, "decode_step", "state", T_OPEN, T_CLOSE) == 31.0
    assert sites.site_ms(EVENTS, "prefill", "scatter", T_OPEN, T_CLOSE) == 50.0
    assert len(sites.spans(EVENTS, "decode_step", T_OPEN, T_CLOSE)) == 3
    assert sites.all_sites_ms(EVENTS, "decode_step", T_OPEN, T_CLOSE) == {
        "attention": 210.0, "ffn": 22.0, "state": 31.0}
    assert sites.host_ms(EVENTS, T_OPEN, T_CLOSE) == pytest.approx(
        {"decode_step": 300.0, "prefill": 100.0})


def test_events_without_the_spans_read_none():
    """A program without these spans stamps ``prefill`` and ``decode_step``
    at their end with ``dur_ms`` only."""
    old = [Event(ts=12.0, step=1, kind="decode_step", data={"dur_ms": 300.0, "n_active": 16}),
           Event(ts=13.0, step=2, kind="prefill", rid=3, data={"dur_ms": 80.0})]
    assert sites.replay_device_ms(old, T_OPEN, T_CLOSE) is None
    for kind, site in (("decode_step", "attention"), ("prefill", "scatter")):
        assert sites.site_ms(old, kind, site, T_OPEN, T_CLOSE) is None
        assert sites.site_ms(EVENTS, kind, "mixer", T_OPEN, T_CLOSE) is None
    assert sites.replay_device_ms([], T_OPEN, T_CLOSE) is None
    assert sites.blocks_over_replay(old) == []


def test_blocks_over_the_replay_are_found():
    bad = step(15.0, 15.3, 100.0, attention=80.0, ffn=15.0, state=10.0)
    assert sites.blocks_over_replay(EVENTS) == []
    assert sites.blocks_over_replay(EVENTS + [bad]) == [150]


def span(kind, t0, t1):
    return Event(ts=t1, step=0, kind=kind, data={"t0": t0, "dur_ms": (t1 - t0) * 1e3})


def test_idle_gaps_go_to_the_innermost_span_at_their_middle():
    events = [span("decode.replay", 1.0, 2.0), span("decode.sync", 2.0, 4.0),
              span("decode_step", 1.0, 4.0), span("decode.emit", 4.0, 4.5),
              span("step", 0.5, 5.0), span("prefill.forward", 6.1, 7.0),
              span("prefill", 6.05, 8.0), span("step", 6.0, 8.1)]
    ops = [Span("k", 0.0, 1.5), Span("k", 1.6, 3.0), Span("k", 3.5, 4.1), Span("k", 4.3, 4.4),
           Span("k", 4.8, 6.2), Span("k", 6.5, 7.8)]
    got = sites.idle_by_span(DeviceTrace(ops, [], 0.0, 9.0), events)
    assert got == pytest.approx({
        "step/decode_step/decode.replay": 0.1, "step/decode_step/decode.sync": 0.5,
        "step/decode.emit": 0.2, "step": 0.4, "step/prefill/prefill.forward": 0.3,
        "outside the engine's spans": 1.2})
    assert list(got)[0] == "outside the engine's spans"  # largest first
    by_op = sites.ops_by_span(DeviceTrace(ops + [Span("memcpy", 1.2, 1.4)], [], 0.0, 9.0),
                              events, top=1)
    assert by_op == {"k": pytest.approx({"all": 6.3, "prefill": 1.3, "decode_step": 2.0})}


def test_a_tiny_traced_cell_reads_every_span(tmp_path):
    """``spans.py`` over a tiny dense cell on the CPU: the engine's events
    are kept, every reading is there, no step's blocks outgrow it."""
    cell_root = tiny_root(tmp_path, moe=False, kind="closed_loop")
    (line,) = spans.spans_runs("tiny-cell", [2**31 + 11], 1.5, device="cpu", root=cell_root)
    assert line["correct"] and line["decode_steps"] > 0
    # a layer: attention, qkv x 3, attn_qk and attn_av once a 16-row chunk of
    # the 64-row cache, out, ffn, mlp_up x 2, mlp_down; then embed, head,
    # logits, state x 2, sample
    assert line["pairs_per_step"] == 2 * (9 + 2 * 4) + 6
    assert line["blocks_over_replay"] == []
    got = line["sites"]
    # the window always holds a decode step; a prefill only where a request ended in it
    prefills = "prefill" in line["host_ms"]
    assert (got.pop("scatter_row_ms.prefill") is not None) == prefills
    assert all(got[name] is not None and got[name] > 0.0 for name in got), got
    assert sum(got[f"{b}_ms.decode"] for b in ("attention", "ffn")) <= got[
        "replay_device_ms.decode"]
    assert "idle_by_span" not in line  # no profiler on the CPU
    assert {"step", "decode_step", "decode.emit", "decode.replay"} <= set(line["host_ms"])
    assert line["sites_ms"]["decode_step"]["ffn"] == got["ffn_ms.decode"]
    assert {"attention/attn_qk", "head/logits", "state"} <= set(line["sites_ms"]["decode_step"])
    assert spec.load_cell("tiny-cell", cell_root).name == "tiny-cell"
