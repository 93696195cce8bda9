"""Continuous-batching serving on the PyTorch/CUDA port: the streaming
submit/step/drain API, staggered arrivals joining slots mid-flight, and
int8 KV-cache quantization.

    PYTHONPATH=src python examples/serve_batched_torch.py                # the GPU
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The port's counterpart of ``examples/serve_batched.py``: the same reduced
qwen1.5-0.5b shapes, the same six ragged requests (numpy seed 0) through
three slots, four submitted first and two joining mid-flight.  On the GPU
the engine's decode step is one captured CUDA graph, replayed per step.
The streamed tokens are checked against the offline batch API on a fresh
engine.  Without ``--device`` it runs on the GPU and raises when there is
none.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.policy import PRESETS
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine

#: the reference's reduced qwen1.5-0.5b shapes
SHAPE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
             remat=False, attn_chunk=64)
SLOTS, MAX_LEN, MAX_NEW = 3, 64, 12


def build(kv_dtype: str, device, params=None):
    """(model, params) at native f32; ``params`` default to the port's
    ``model.init(0)``."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), kv_cache_dtype=kv_dtype, **SHAPE)
    model = build_model(cfg.with_policy(PRESETS["native_f32"]), device=device)
    return model, (model.init(0) if params is None else params)


def requests() -> list[Request]:
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SHAPE["vocab"], rng.integers(4, 12)).astype(np.int32)
               for _ in range(6)]
    return [Request(prompt=p, max_new=MAX_NEW, rid=i) for i, p in enumerate(prompts)]


def engine(model, params) -> ServeEngine:
    return ServeEngine(model, params, config=ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN))


def main(argv=None, *, params=None) -> dict:
    """``params``: initial parameters for both engines (e.g. converted from
    another package's draws); default ``model.init(0)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reqs = requests()

    # streaming API: 6 ragged requests through 3 slots, two joining late —
    # they take over slots freed by earlier completions (mid-flight join)
    model, params = build("bfloat16", dev, params)
    eng = engine(model, params)
    events = []
    for r in reqs[:4]:
        eng.submit(dataclasses.replace(r))
    for _ in range(4):
        for rid, tok in eng.step():
            events.append((rid, tok))
            print(f"  step event: req {rid} -> {tok}")
    for r in reqs[4:]:
        eng.submit(dataclasses.replace(r))  # arrive while the first wave is still decoding
    outs = {"bfloat16": eng.drain()}
    print(eng.metrics.format_summary())
    summary = eng.metrics.summary()
    captures = eng.graph_capture_count

    # the offline batch API on a fresh engine: the same tokens per request
    batch = engine(model, params).generate_batch([dataclasses.replace(r) for r in reqs])
    stream_equals_batch = batch == outs["bfloat16"]
    print(f"batch API reproduces the streamed tokens: {stream_equals_batch}")

    # same workload, int8 KV cache (offline batch API)
    model8, params8 = build("int8", dev, params)
    outs["int8"] = engine(model8, params8).generate_batch([dataclasses.replace(r) for r in reqs])
    for kv_dtype in outs:
        print(f"kv_cache={kv_dtype}:")
        for rid in sorted(outs[kv_dtype]):
            print(f"  req {rid}: {outs[kv_dtype][rid]}")

    agree = sum(outs["bfloat16"][r.rid] == outs["int8"][r.rid] for r in reqs)
    print(f"int8-KV agrees with bf16-KV on {agree}/{len(reqs)} requests "
          f"(greedy decode; small divergence is the quantization trade)")
    return {"device": str(dev), "events": events, "outputs": outs, "batch": batch,
            "stream_equals_batch": stream_equals_batch, "agree": agree,
            "requests": len(reqs), "summary": summary, "graph_captures": captures}


if __name__ == "__main__":
    main()
