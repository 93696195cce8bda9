"""The decode-attention kernel (``kernels/decode_attention``) and its route
in ``models.layers.flash_attention``.  Imports no JAX: the card's tests
(``chip``) run here too, where they skip.

On the CPU: every condition of the route keeps the chunk loop, while
bound sites and other K/V layouts are taken; the wrapper on CPU tensors is
its plain version; ``flash_attention`` gives the chunk loop's bits as it was
before the kernel existed (``_parent_loop``, kept here verbatim) at every
f32-ladder mode, over per-slot ragged, shared-length and wrapped windowed
caches, at G = 1 and 4; ``held_to_plain`` refuses planted faults.  On the
card: the kernel against its plain version at the benchmark cells' shapes
and RecurrentGemma's (and planted faults refused there), modes bound as
device scalars against host modes, captured in a CUDA graph, and an
engine's tokens against the chunk loop's.

    python -m pytest tests/test_torch_decode_attention.py -m chip   # on the card
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.adapt import bind_modes
from repro_torch.configs import get_config
from repro_torch.core import Mode, PrecisionPolicy
from repro_torch.core.rmpm import mp_einsum
from repro_torch.distributed.sharding import split_dim
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.decode_attention.ops import attention_f64, drop_top_key, held_to_plain
from repro_torch.launch import op_cost
from repro_torch.models import build_model, layers
from repro_torch.serve import Request, ServeConfig, ServeEngine

MODES = (Mode.M8, Mode.M16, Mode.M24)
POLICY = PrecisionPolicy(default=Mode.M16, impl="pallas")


def _rand(rng, *shape, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


def _decode_case(g: int = 2, hd: int = 16, b: int = 2, s: int = 24, hkv: int = 2, seed: int = 0):
    """q (B, 1, Hq, hd) f32 and a bf16 per-slot cache whose rows hold
    ragged lengths; the query sits after each row's last key."""
    rng = np.random.default_rng(seed)
    q = _rand(rng, b, 1, hkv * g, hd)
    k = _rand(rng, b, s, hkv, hd, dtype=torch.bfloat16)
    v = _rand(rng, b, s, hkv, hd, dtype=torch.bfloat16)
    lens = [1 + (7 * i + 3) % s for i in range(b)]
    pos = torch.full((b, s), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        pos[i, :n] = torch.arange(n, dtype=torch.int32)
    return q, k, v, torch.tensor(lens, dtype=torch.int32) - 1, pos


# ---------------------------------------------------------------------------
# the route (CPU)
# ---------------------------------------------------------------------------


def _misses(q, k, v, policy=POLICY, **kw):
    return layers.decode_kernel_misses(q, k, v, policy, kw.get("k_scale"), kw.get("v_scale"))


def _disqualified(name):
    """(q, k, v, policy, scales) of a decode call that misses the route by
    ``name`` (and, on the CPU, by ``device``)."""
    q, k, v, _, _ = _decode_case()
    policy, scales = POLICY, {}
    if name == "sq":
        q = torch.cat([q, q], dim=1)
    elif name == "grad":
        q = q.clone().requires_grad_()
    elif name == "cache-f32":  # Whisper's cross-attention
        k, v = k.float(), v.float()
    elif name == "cache-int8":
        k, v = k.to(torch.int8), v.to(torch.int8)
        scales = dict(k_scale=torch.ones(k.shape[:3] + (1,)), v_scale=torch.ones(v.shape[:3] + (1,)))
    elif name in ("impl-xla", "impl-native"):
        policy = POLICY.with_impl(name.split("-")[1])
    elif name == "mode":
        policy = PrecisionPolicy(default=Mode.M16, overrides=(("attn_av", Mode.M32),),
                                 impl="pallas")
    elif name == "shape-hd":
        q, k, v, _, _ = _decode_case(hd=24)
    elif name == "shape-hd-wide":
        q, k, v, _, _ = _decode_case(hd=272, s=8)
    elif name == "shape-group":
        q, k, v, _, _ = _decode_case(g=32, s=8)
    return q, k, v, policy, scales


ROUTE_CASES = ("sq", "grad", "cache-f32", "cache-int8", "impl-xla", "impl-native", "mode",
               "shape-hd", "shape-hd-wide", "shape-group")


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_every_disqualifier_keeps_the_chunk_loop(name):
    """Each condition of the route, broken alone, is named and keeps the
    chunk loop (``flash_attention`` then returns its bits); a qualifying
    call on the CPU misses by the device alone."""
    q, k, v, _, _ = _decode_case()
    assert _misses(q, k, v) == ("device",)
    q, k, v, policy, scales = _disqualified(name)
    want = name.split("-")[0]
    assert _misses(q, k, v, policy, **scales) == ("device", want)
    # the call runs the chunk loop: the same bits as the policy-routed loop
    qoff = torch.zeros((q.shape[0],), dtype=torch.int32) + k.shape[1] - 1
    got = layers.flash_attention(q, k, v, policy, q_offset=qoff, chunk=16, **scales)
    loop = layers._flash_attention_chunks(q, k, v, policy, q_offset=qoff, chunk=16, **scales)
    assert torch.equal(got, loop)


def _taken(name):
    """(q, k, v, binding) of a decode call the route takes although it
    binds its sites' modes at run time or lays K out otherwise."""
    q, k, v, _, _ = _decode_case()
    binding = {}
    if name == "bound-host":
        binding = {"attn_qk": 3, "attn_av": Mode.M8}
    elif name == "bound-device":
        binding = {"*": torch.tensor(1, dtype=torch.int32)}
    elif name == "layout":  # hd not innermost: copied before the launch
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    return q, k, v, binding


@pytest.mark.parametrize("name", ["bound-host", "bound-device", "layout"])
def test_bound_sites_and_other_layouts_take_the_route(name):
    """A site bound at run time (a host int or a device scalar) or a K laid
    out otherwise than the kernel reads misses by nothing but the CPU; on
    the CPU the call keeps the chunk loop's bits."""
    q, k, v, binding = _taken(name)
    qoff = torch.zeros((q.shape[0],), dtype=torch.int32) + k.shape[1] - 1
    with bind_modes(binding):
        assert _misses(q, k, v) == ("device",)
        got = layers.flash_attention(q, k, v, POLICY, q_offset=qoff, chunk=16)
        loop = layers._flash_attention_chunks(q, k, v, POLICY, q_offset=qoff, chunk=16)
    assert torch.equal(got, loop)


@pytest.mark.parametrize("bound", [None, 0, 1, 2, 3, 5, "device"])
def test_site_mode_is_the_mode_pein_runs(bound):
    """``_site_mode``: the policy's mode where nothing is bound, a bound host
    int clamped to the f32 ladder as ``mp_einsum_runtime`` clamps it, a
    bound device scalar as it is."""
    scalar = torch.tensor(2, dtype=torch.int32)
    binding = {} if bound is None else {"attn_qk": scalar if bound == "device" else bound}
    with bind_modes(binding):
        got = layers._site_mode("attn_qk", POLICY)
        assert layers._site_mode("attn_av", POLICY) == Mode.M16
    if bound is None:
        assert got == Mode.M16
    elif bound == "device":
        assert got is scalar
    else:
        assert got == (Mode.M8, Mode.M8, Mode.M16, Mode.M24, Mode.M24)[(0, 1, 2, 3, 5).index(bound)]
        assert type(got) is Mode


@pytest.mark.parametrize("value", [0, 1, 2, 3, 4])
def test_the_wrapper_takes_a_bound_mode_as_a_scalar(value):
    """A mode given as an integer scalar (what an adaptive step binds) gives
    the bits of the static mode it clamps to, on the CPU through the plain
    version's run-time einsums; a mode of another shape or dtype raises."""
    q, k, v, qpos, pos = _decode_case(g=2)
    static = (Mode.M8, Mode.M8, Mode.M16, Mode.M24, Mode.M24)[value]
    scalar = torch.tensor(value, dtype=torch.int32)
    want = decode_attention(q, k, v, qpos, pos, qk_mode=static, av_mode=Mode.M16)
    got = decode_attention(q, k, v, qpos, pos, qk_mode=scalar, av_mode=Mode.M16)
    assert torch.equal(got, want)
    want = decode_attention(q, k, v, qpos, pos, qk_mode=Mode.M16, av_mode=static)
    got = decode_attention(q, k, v, qpos, pos, qk_mode=Mode.M16, av_mode=scalar)
    assert torch.equal(got, want)
    for bad in (torch.tensor([1, 2], dtype=torch.int32), torch.tensor(2.0)):
        with pytest.raises(ValueError):
            decode_attention(q, k, v, qpos, pos, qk_mode=bad, av_mode=Mode.M16)


#: (mode, fault): every mode as it is and with a key dropped, and each mode
#: beside its neighbours on the ladder
PLANTED = tuple((m, f) for m in MODES for f in ("none", "key-dropped")) + (
    (Mode.M8, "mode-up"), (Mode.M16, "mode-up"), (Mode.M16, "mode-down"),
    (Mode.M24, "mode-down"))


@pytest.mark.parametrize("mode,fault", PLANTED, ids=lambda x: getattr(x, "name", x))
def test_held_to_plain_refuses_planted_faults(mode, fault):
    """``held_to_plain`` on the CPU, the plain version at 8-column chunks
    standing in for the kernel's partitions (its p split against other
    maxima): the same modes hold; one key too few, or a neighbouring mode,
    is refused."""
    q, k, v, qpos, pos = _card_case(4, 96, 2, 2, 32, (96, 40, 77, 9), seed=7, device="cpu")
    exact, wabs = attention_f64(q, k, v, qpos, pos)
    plain = decode_attention_plain(q, k, v, qpos, pos, qk_mode=mode, av_mode=mode)
    at, cut = mode, pos
    if fault == "key-dropped":
        cut = drop_top_key(q, k, qpos, pos)
        assert int((cut < 0).sum() - (pos < 0).sum()) == q.shape[0]
    elif fault != "none":
        at = MODES[MODES.index(mode) + (1 if fault == "mode-up" else -1)]
    sim = decode_attention_plain(q, k, v, qpos, cut, qk_mode=at, av_mode=at, chunk=8)
    got = held_to_plain(sim, plain, exact, wabs, qk_mode=mode, av_mode=mode)
    assert got["ok"] == (fault == "none"), got


def test_the_wrapper_on_the_cpu_is_its_plain_version():
    q, k, v, qpos, pos = _decode_case(g=4)
    kw = dict(qk_mode=Mode.M16, av_mode=Mode.M24, rounding="grte", window=9)
    build.reset_launch_counts()
    got = decode_attention(q, k, v, qpos, pos, **kw)
    assert torch.equal(got, decode_attention_plain(q, k, v, qpos, pos, **kw))
    assert build.launch_counts()["decode_attention"] == 0  # no kernel on the CPU
    _, rec = op_cost.record_ops(lambda: decode_attention(q, k, v, qpos, pos, **kw))
    kernels = [ev for ev in rec.events if ev.kind == "kernel"]
    assert [ev.name for ev in kernels] == ["decode_attention"]
    b, _, hq, hd = q.shape
    assert kernels[0].flops == 2.0 * b * hq * k.shape[1] * hd * (2 + 3)
    with pytest.raises(ValueError):
        decode_attention(q, k, v, qpos, pos, qk_mode=Mode.M32, av_mode=Mode.M16)
    with torch.enable_grad(), pytest.raises(NotImplementedError):
        decode_attention(q.clone().requires_grad_(), k, v, qpos, pos, **kw)


# ---------------------------------------------------------------------------
# flash_attention on the CPU: the chunk loop's bits, unchanged
# ---------------------------------------------------------------------------


def _parent_loop(q, k, v, policy, *, window, q_offset, kv_positions, chunk):
    """The chunk loop of ``flash_attention`` as it was before the kernel,
    for a decode call with positions and a bf16 cache (no scales), with its
    policy-routed einsums written as ``mp_einsum`` at the policy's modes."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=-1)
    qg = split_dim(q, 2, hkv, g).to(torch.float32) * (hd**-0.5)
    q_offset = torch.as_tensor(q_offset)
    q_pos = (q_offset[:, None] if q_offset.dim() else q_offset) + torch.arange(sq)
    q_b = q_pos if q_pos.dim() == 2 else q_pos[None, :]
    m = torch.full((b, hkv, g, sq), -float("inf"), dtype=torch.float32)
    lse = torch.zeros((b, hkv, g, sq), dtype=torch.float32)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kt, vt = k[:, sl].to(torch.float32), v[:, sl].to(torch.float32)
        s = mp_einsum("bqhgd,bkhd->bhgqk", qg, kt, policy.mode_for("attn_qk"),
                      rounding=policy.rounding, impl=policy.impl, device="cpu")
        kv_pos = kv_positions[..., sl]
        kv_b = kv_pos if kv_pos.dim() == 2 else kv_pos[None, :]
        valid = (kv_b[:, None, :] >= 0) & (kv_b[:, None, :] <= q_b[:, :, None])
        if window:
            valid = valid & (kv_b[:, None, :] > q_b[:, :, None] - window)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lse = lse * alpha + p.sum(dim=-1)
        pv = mp_einsum("bhgqk,bkhd->bhgqd", p, vt, policy.mode_for("attn_av"),
                       rounding=policy.rounding, impl=policy.impl, device="cpu")
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(lse, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)


def _layout(name: str, g: int):
    """(q, k, v, q_offset, kv_positions, window) of one cache layout."""
    q, k, v, qpos, pos = _decode_case(g=g, b=3, s=40)
    if name == "per_slot":  # ragged lengths, one partial chunk
        return q, k, v, qpos, pos, 0
    if name == "shared":  # one length for every row: (S,) positions, a scalar offset
        shared = torch.where(torch.arange(40) < 23, torch.arange(40), -1).to(torch.int32)
        return q, k, v, torch.tensor(22, dtype=torch.int32), shared, 0
    # a ring of 40 columns that has wrapped: row i's column c holds position
    # c + 40 * w_i, or c + 40 * (w_i - 1) past its write point; window 24
    wraps, heads = torch.tensor([1, 2, 3]), torch.tensor([7, 0, 33])
    col = torch.arange(40)[None, :]
    ring = torch.where(col < heads[:, None], col + 40 * wraps[:, None],
                       col + 40 * (wraps[:, None] - 1)).to(torch.int32)
    return q, k, v, (heads + 40 * wraps - 1).to(torch.int32), ring, 24


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("layout", ["per_slot", "shared", "ring"])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_attention_on_the_cpu_keeps_the_chunk_loop_bits(mode, layout, g):
    q, k, v, qoff, pos, window = _layout(layout, g)
    policy = PrecisionPolicy(default=mode, impl="pallas", rounding="rne" if g == 1 else "grte")
    got = layers.flash_attention(q, k, v, policy, window=window, q_offset=qoff,
                                 kv_positions=pos, chunk=16)
    want = _parent_loop(q, k, v, policy, window=window, q_offset=qoff, kv_positions=pos,
                        chunk=16)
    assert torch.equal(got, want)
    # the kernel's plain version is the same loop at the same modes
    qpos = qoff.expand(q.shape[0])
    plain = decode_attention(q, k, v, qpos, pos, qk_mode=mode, av_mode=mode,
                             rounding=policy.rounding, window=window, chunk=16)
    assert torch.equal(plain, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _held(got, q, k, v, qpos, pos, *, mode, rounding="rne", window=0, planted=True):
    """``got`` (the kernel at ``mode``) holds to the plain version, and with
    planted faults (a key dropped; a neighbouring mode) it would not."""
    kw = dict(rounding=rounding, window=window)
    exact, wabs = attention_f64(q, k, v, qpos, pos, window=window)
    plain = decode_attention_plain(q, k, v, qpos, pos, qk_mode=mode, av_mode=mode, **kw)
    res = held_to_plain(got, plain, exact, wabs, qk_mode=mode, av_mode=mode, rounding=rounding)
    assert res["ok"], res
    if not planted:
        return
    faults = {"key-dropped": decode_attention(q, k, v, qpos,
                                              drop_top_key(q, k, qpos, pos, window=window),
                                              qk_mode=mode, av_mode=mode, **kw)}
    i = MODES.index(mode)
    for j in (i - 1, i + 1):
        if 0 <= j < len(MODES):
            faults[MODES[j].name] = decode_attention(q, k, v, qpos, pos, qk_mode=MODES[j],
                                                     av_mode=MODES[j], **kw)
    for name, bad in faults.items():
        res = held_to_plain(bad, plain, exact, wabs, qk_mode=mode, av_mode=mode,
                            rounding=rounding)
        assert not res["ok"], (name, res)


def _card_case(b, s, hkv, g, hd, lens, *, seed, ring_wrap=False, device="cuda"):
    rng = np.random.default_rng(seed)
    q = _rand(rng, b, 1, hkv * g, hd, device=device)
    k = _rand(rng, b, s, hkv, hd, dtype=torch.bfloat16, device=device)
    v = _rand(rng, b, s, hkv, hd, dtype=torch.bfloat16, device=device)
    pos = torch.full((b, s), -1, dtype=torch.int32)
    qpos = torch.zeros((b,), dtype=torch.int32)
    for i, n in enumerate(lens):
        if ring_wrap and n > s:  # a ring that wrapped: the newest s positions
            head = n % s
            col = torch.arange(s)
            pos[i] = torch.where(col < head, col + n - head, col + n - head - s).to(torch.int32)
        else:
            pos[i, :n] = torch.arange(n, dtype=torch.int32)
        qpos[i] = n - 1
    return q, k, v, qpos.to(device), pos.to(device)


#: (name, B, S, Hkv, G, hd, window, lengths): the dense cell's and the MoE
#: cell's shapes with ShareGPT-like lengths (1, partial, full; partitions
#: with no valid column), RecurrentGemma's local attention (a wrapped
#: 2048-ring, window 2048, one KV head of 256 for 16 query heads), and a
#: window of 200 over full rows, whose only valid keys sit in the last
#: partitions
CARD_CASES = (
    ("phi3mini", 16, 2048, 32, 1, 96, 0,
     (1, 2048, 161, 499, 700, 1023, 1024, 1025, 12, 300, 1500, 257, 256, 90, 2000, 640)),
    ("phi35moe", 16, 1024, 8, 4, 128, 0,
     (1, 1024, 161, 499, 700, 1023, 512, 513, 12, 300, 80, 257, 256, 90, 1000, 640)),
    ("recurrentgemma", 2, 2048, 1, 16, 256, 2048, (3000, 700)),
    ("window_tail", 2, 2048, 2, 2, 64, 200, (2048, 1900)),
)


@pytest.mark.chip
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_kernel_matches_its_plain_version_on_the_card(cuda, mode, case):
    name, b, s, hkv, g, hd, window, lens = case
    q, k, v, qpos, pos = _card_case(b, s, hkv, g, hd, lens, seed=len(name),
                                    ring_wrap=window > 0)
    build.reset_launch_counts()
    got = decode_attention(q, k, v, qpos, pos, qk_mode=mode, av_mode=mode, window=window)
    torch.cuda.synchronize()
    assert build.launch_counts()["decode_attention"] == 1
    _held(got, q, k, v, qpos, pos, mode=mode, window=window)


@pytest.mark.chip
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_kernel_over_a_paged_view_and_shared_positions(cuda, mode):
    """A paged cache's gathered view (batch stride past the view's rows),
    (S,) shared positions with a scalar length, GRTE limbs, and a row of
    one key."""
    rng = np.random.default_rng(3)
    pages, ps, hkv, hd, g, b = 40, 16, 4, 64, 2, 3
    pool_k = _rand(rng, pages, ps, hkv, hd, dtype=torch.bfloat16, device=cuda)
    pool_v = _rand(rng, pages, ps, hkv, hd, dtype=torch.bfloat16, device=cuda)
    tbl = torch.as_tensor(rng.permutation(pages)[: b * 9].reshape(b, 9), device=cuda)
    cap = 8 * ps + 5  # the view is cut inside the last page
    k = pool_k[tbl].reshape(b, 9 * ps, hkv, hd)[:, :cap]
    v = pool_v[tbl].reshape(b, 9 * ps, hkv, hd)[:, :cap]
    assert not k.is_contiguous()
    q = _rand(rng, b, 1, hkv * g, hd, device=cuda)
    pos = torch.full((b, cap), -1, dtype=torch.int32, device=cuda)
    for i, n in enumerate((1, 77, cap)):
        pos[i, :n] = torch.arange(n, dtype=torch.int32, device=cuda)
    qpos = torch.tensor([0, 76, cap - 1], dtype=torch.int32, device=cuda)
    kw = dict(qk_mode=mode, av_mode=mode, rounding="grte")
    got = decode_attention(q, k, v, qpos, pos, **kw)
    _held(got, q, k, v, qpos, pos, mode=mode, rounding="grte", planted=False)
    shared = torch.where(torch.arange(cap, device=cuda) < 50,
                         torch.arange(cap, device=cuda), -1).to(torch.int32)
    qs = torch.full((b,), 49, dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, qs, shared, **kw)
    _held(got, q, k, v, qs, shared, mode=mode, rounding="grte", planted=False)


@pytest.mark.chip
def test_kernel_captured_in_a_graph_equals_eager(cuda):
    """One capture; the lengths and positions change between replays, as the
    decode step's do, and every replay equals the eager call bit for bit."""
    b, s, hkv, g, hd = 4, 1024, 8, 4, 128
    q, k, v, qpos, pos = _card_case(b, s, hkv, g, hd, (5, 300, 1024, 700), seed=11)
    kw = dict(qk_mode=Mode.M16, av_mode=Mode.M16)
    decode_attention(q, k, v, qpos, pos, **kw)  # build, prepare the device
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = decode_attention(q, k, v, qpos, pos, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    for lens in ((5, 300, 1024, 700), (6, 301, 1, 1000), (1024, 1, 257, 256)):
        _, _, _, qp2, pos2 = _card_case(b, s, hkv, g, hd, lens, seed=11)
        qpos.copy_(qp2)
        pos.copy_(pos2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention(q, k, v, qpos, pos, **kw)), lens


@pytest.mark.chip
def test_bound_modes_read_on_the_card_equal_host_modes(cuda):
    """Modes bound as int32 device scalars (one vector, as ``DeviceModes``
    holds them) give the bits of the static modes they clamp to, eager and
    in one captured graph whose scalars are rewritten between replays; and
    ``flash_attention`` under a binding of host ints and of device scalars
    launches the kernel and gives the same bits."""
    b, s, hkv, g, hd = 4, 1024, 8, 4, 128
    q, k, v, qpos, pos = _card_case(b, s, hkv, g, hd, (5, 300, 1024, 700), seed=13)
    buf = torch.zeros((2,), dtype=torch.int32, device=cuda)
    scalars = dict(qk_mode=buf[0], av_mode=buf[1])
    clamp = {0: Mode.M8, 1: Mode.M8, 2: Mode.M16, 3: Mode.M24, 4: Mode.M24}
    pairs = ((2, 2), (0, 3), (3, 1), (1, 4), (2, 3))
    for qk, av in pairs:
        buf.copy_(torch.tensor([qk, av], dtype=torch.int32))
        got = decode_attention(q, k, v, qpos, pos, **scalars)
        want = decode_attention(q, k, v, qpos, pos, qk_mode=clamp[qk], av_mode=clamp[av])
        assert torch.equal(got, want), (qk, av)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = decode_attention(q, k, v, qpos, pos, **scalars)
    torch.cuda.current_stream().wait_stream(stream)
    for qk, av in pairs:
        buf.copy_(torch.tensor([qk, av], dtype=torch.int32))
        graph.replay()
        want = decode_attention(q, k, v, qpos, pos, qk_mode=clamp[qk], av_mode=clamp[av])
        torch.cuda.synchronize()
        assert torch.equal(out, want), (qk, av)
    policy = PrecisionPolicy(default=Mode.M24, impl="tile")
    outs = []
    for binding in ({"attn_qk": 1, "attn_av": 2}, {"attn_qk": buf[0], "attn_av": buf[1]}):
        buf.copy_(torch.tensor([1, 2], dtype=torch.int32))
        build.reset_launch_counts()
        with bind_modes(binding):
            outs.append(layers.flash_attention(q, k, v, policy, q_offset=qpos,
                                               kv_positions=pos))
        assert build.launch_counts()["decode_attention"] == 1
    want = decode_attention(q, k, v, qpos, pos, qk_mode=Mode.M8, av_mode=Mode.M16)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want)


@pytest.mark.chip
def test_engine_tokens_equal_the_chunk_loop_route(cuda, monkeypatch):
    """A Phi-3-mini-shaped model (full width, 2 layers) at M16 on the limb
    kernel: the captured engine's greedy tokens through the decode-attention
    kernel equal those through the chunk loop (the route forced off)."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=2, policy=POLICY)
    model = build_model(cfg, device=cuda)
    params = model.init(0)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=12, rid=i)
            for i, n in enumerate((5, 40, 17, 90, 3, 61))]
    config = ServeConfig(batch_slots=4, max_len=256)
    build.reset_launch_counts()
    eng = ServeEngine(model, params, config=config)
    got = eng.generate_batch(reqs)
    eng.close()
    assert build.launch_counts()["decode_attention"] > 0
    monkeypatch.setattr(layers, "decode_kernel_misses", lambda *a, **kw: ("forced",))
    build.reset_launch_counts()
    eng = ServeEngine(model, params, config=config)
    want = eng.generate_batch(reqs)
    eng.close()
    assert build.launch_counts()["decode_attention"] == 0
    assert got == want
