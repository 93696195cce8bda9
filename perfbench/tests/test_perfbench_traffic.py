"""Traffic: the same seed gives the same requests; another seed the same
sizes in another order; a new mix is new files and entries only."""
import json

import numpy as np
import pytest
from conftest import tiny_root

from harness import spec


def draw(cell, seed, seconds=40.0):
    load = spec.traffic_kind(cell).Load(cell.traffic, seed, cell.sizes.vocab, seconds)
    reqs = [(p.tolist(), n) for p, n in load.warm()]
    if load.closed:
        reqs += [(p.tolist(), n) for p, n in (load.replace() for _ in range(40))]
    else:
        reqs += [(t, p.tolist(), n) for t, p, n in load.due(seconds)]
    return reqs


@pytest.mark.parametrize("workload", ["phi3mini-decode-m16", "phi35moe-decode-m16", "poisson"])
def test_same_seed_same_traffic(tmp_path, workload):
    cell = poisson_cell(tmp_path) if workload == "poisson" else spec.load_cell(workload)
    big = 2**31 + 12345
    assert draw(cell, big) == draw(cell, big)
    assert draw(cell, big) != draw(cell, big + 1)


def test_closed_loop_seeds_share_the_sizes():
    cell = spec.load_cell("phi3mini-decode-m16")
    kind = spec.traffic_kind(cell)
    a = kind.Load(cell.traffic, 1, cell.sizes.vocab, 40.0)
    b = kind.Load(cell.traffic, 2, cell.sizes.vocab, 40.0)
    assert sorted(zip(a.prompts, a.outputs)) == sorted(zip(b.prompts, b.outputs))
    assert not np.array_equal(a.prompts, b.prompts)


def poisson_cell(tmp_path):
    """The tiny open-loop cell, added as files (no cell of the benchmark is
    an open loop yet)."""
    return spec.load_cell("tiny-cell", tiny_root(tmp_path, moe=False, kind="poisson"))


def test_open_loop_replays_one_schedule(tmp_path):
    """The arrivals and lengths come from the mix's schedule seed; the run's
    seed changes only the tokens."""
    cell = poisson_cell(tmp_path)
    a = draw(cell, 1, 5.0)
    b = draw(cell, 2, 5.0)
    assert [(t, len(p), n) for t, p, n in a[2:]] == [(t, len(p), n) for t, p, n in b[2:]]
    assert [p for _, p, _ in a[2:]] != [p for _, p, _ in b[2:]]


def test_lengths_keep_to_their_bounds():
    for workload in ("phi3mini-decode-m16", "phi35moe-decode-m16"):
        cell = spec.load_cell(workload)
        tr = cell.traffic
        load = spec.traffic_kind(cell).Load(tr, 7, cell.sizes.vocab, 51.0)
        assert tr["prompt"]["min"] <= load.prompts.min() <= load.prompts.max() <= tr["prompt"]["max"]
        assert (load.prompts + load.outputs <= tr["max_len"]).all()
        for prompt, n in load.warm():
            assert len(prompt) + n <= tr["max_len"] and n >= 1
            if tr["kind"] == "closed_loop":
                assert len(prompt) <= tr["max_prefill"] and n >= 2


def test_moe_prefills_fit_one_routing_group():
    """A prefill longer than the routing group must be a multiple of it;
    the MoE mix keeps every prefill within one group."""
    cell = spec.load_cell("phi35moe-decode-m16")
    group = cell.config["serving"]["moe_group_size"]
    load = spec.traffic_kind(cell).Load(cell.traffic, 99, cell.sizes.vocab, 51.0)
    assert max(len(p) for p, _ in load.warm()) <= group
    assert load.prompts.max() <= group


def test_poisson_rate_is_the_mixes(tmp_path):
    cell = poisson_cell(tmp_path)
    load = spec.traffic_kind(cell).Load(cell.traffic, 5, cell.sizes.vocab, 400.0)
    n = len(load.due(400.0))
    assert abs(n / 400.0 - cell.traffic["rate"]) < 0.1 * cell.traffic["rate"]


def test_a_new_mix_is_new_files_only(tmp_path):
    """A dummy mix and metric, added as files and entries: the harness finds
    them by name, and no file of the benchmark changed."""
    root = tiny_root(tmp_path, moe=False, kind="poisson")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    (root / "perfbench/metrics/dummy_share.py").write_text(
        'LAYER = "device"\nMOVES = "output_tokens_per_s"\n\n\ndef read(run):\n    return 1.0\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "output_tokens_per_s", "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny-cell", root)
    assert cell.traffic["kind"] == "poisson"
    assert [m["name"] for m in cell.metrics(True)] == ["dummy_share"]
    assert spec.metric_reader(cell, "dummy_share").read(None) == 1.0
    assert draw(cell, 3, 2.0)
    for path, data in before.items():
        assert path.read_bytes() == data


def test_every_metric_has_a_reader_that_names_its_layer():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell("phi3mini-decode-m16")
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = spec.metric_reader(cell, m["name"])
        assert reader.LAYER == m.get("layer") and reader.MOVES == m.get("moves"), m["name"]
