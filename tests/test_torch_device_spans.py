"""Device spans (repro_torch.obs.device): the recording's tree on the host
clock, the no-op when no recording is open, and — on the card (``chip``) —
timing events captured into a compiled step's graph and read after each
replay, and a traced engine's per-block device time.  Imports no JAX: the
card's tests run here too, where they skip.

    python -m pytest tests/test_torch_device_spans.py -m chip   # on the card
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Mode, PrecisionPolicy
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig
from repro_torch.obs import TraceConfig, Tracer
from repro_torch.obs import device as obs_device
from repro_torch.obs.device import Recording, device_span
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.graphs import CompiledStep


def test_no_recording_is_one_shared_no_op():
    assert obs_device._RECORDING is None
    assert device_span("a") is device_span("b")
    with device_span("a"):
        pass


def test_recording_nests_paths_counts_and_restores():
    outer, inner = Recording("cpu"), Recording("cpu")
    with outer:
        with device_span("attention"):
            with device_span("qkv"):
                pass
            with device_span("qkv"):
                pass
        with inner:
            with device_span("head"):
                pass
        assert obs_device._RECORDING is outer
        with device_span("ffn"):
            pass
    assert obs_device._RECORDING is None
    ms, n = outer.read()
    assert n == {"attention/qkv": 2, "attention": 1, "ffn": 1}
    assert ms["attention"] >= ms["attention/qkv"] >= 0.0
    assert inner.read()[1] == {"head": 1}
    assert Recording("cpu").read() == ({}, {})


def test_eager_compiled_step_records_every_call():
    x = torch.ones(8, 8)

    def fn():
        with device_span("op"):
            return x @ x

    step = CompiledStep(fn, "cpu", name="t", tracer=Tracer())
    for _ in range(2):
        step()
        device_ms, ms, n = step.read()
        assert n == {"op": 1} and 0.0 <= ms["op"] <= device_ms


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _tiny_model(device, family="dense"):
    moe = dict(moe_experts=4, moe_top_k=2, moe_group_size=32) if family == "moe" else {}
    cfg = ArchConfig(name=f"tiny-{family}", family=family, n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=96, vocab=512, attn_chunk=16,
                     policy=PrecisionPolicy(default=Mode.M16, impl="pallas"), **moe)
    model = build_model(cfg, device=device)
    return model, model.init(0)


def _requests(n, vocab):
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, vocab, 5 + 3 * i).astype(np.int32), max_new=6, rid=i)
            for i in range(n)]


@pytest.mark.chip
def test_captured_timing_events_read_the_op(cuda):
    """Events captured around one op of a two-op graph read that op's time
    at every replay, no more than the replay's own."""
    a = torch.randn(2048, 2048, device=cuda)
    out = torch.empty_like(a)

    def fn():
        with device_span("matmul"):
            torch.matmul(a, a, out=out)
        out.add_(1.0)
        return out

    step = CompiledStep(fn, cuda, name="two_ops", tracer=Tracer())
    step()  # warm-up, capture, first replay
    torch.cuda.synchronize()
    assert step.graph is not None and step.captures == 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        torch.matmul(a, a, out=out)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / 5
    for _ in range(3):
        step()
        torch.cuda.synchronize()
        device_ms, ms, n = step.read()
        assert n == {"matmul": 1}
        assert 0.0 < ms["matmul"] <= device_ms
        assert 0.5 * eager_ms < ms["matmul"] < 2.0 * eager_ms


@pytest.mark.chip
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_traced_engine_times_its_blocks_on_the_card(cuda, family, monkeypatch):
    model, params = _tiny_model(cuda, family)
    reqs = _requests(3, model.cfg.vocab)
    made = []
    real_event = torch.cuda.Event

    def counting_event(*a, **kw):
        made.append(1)
        return real_event(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    off = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=48))
    want = off.generate_batch(reqs)
    assert made == [] and off.graph_capture_count == 1
    on = ServeEngine(model, params, config=ServeConfig(batch_slots=2, max_len=48,
                                                       trace=TraceConfig()))
    assert on.generate_batch(reqs) == want
    assert made
    events = list(on.tracer.events)
    steps = [e.data for e in events if e.kind == "decode_step"]
    assert steps
    for d in steps:
        blocks = d["sites_ms"]["attention"] + d["sites_ms"]["ffn"] + d["sites_ms"]["state"]
        assert 0.0 < blocks <= d["device_ms"] <= d["dur_ms"]
        assert d["sites_n"]["attention"] == d["sites_n"]["ffn"] == 2
        # the decode-attention kernel's launches, one span a layer, in place
        # of the chunk loop's einsums
        assert d["sites_n"]["attention/attn_decode"] == 2
        assert 0.0 < d["sites_ms"]["attention/attn_decode"] <= d["sites_ms"]["attention"]
        assert "attention/attn_qk" not in d["sites_n"] and "attention/attn_av" not in d["sites_n"]
    op = "ffn/moe_expert" if family == "moe" else "ffn/mlp_up"
    assert steps[-1]["sites_ms"][op] > 0.0
    captures = [e for e in events if e.kind == "capture"]
    assert len(captures) == 1 and captures[0].data["capture_s"] > 0.0
    prefills = [e.data for e in events if e.kind == "prefill"]
    assert len(prefills) == 3 and all(d["sites_ms"]["scatter"] > 0.0 for d in prefills)
    on.close()
    off.close()
