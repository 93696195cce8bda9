"""Synthetic ill-conditioned serving workload for the adaptation loop.

The closed loop (probe -> controller -> mode table) is only demonstrable on
a workload whose numerical error genuinely depends on the *data*.  Floating
point is scale-invariant, so "big inputs" prove nothing; what low RMPM
modes actually lose is *cancellation* — sums whose true value is far
smaller than their terms.  This module doctors a 1-layer dense model so a
designated set of "hot" token ids manufactures exactly that inside the
decode step's attention, while ordinary tokens stay numerically tame:

  * queries are constant (``wq = 0``, bias-only along a slow-RoPE direction
    ``kappa_q``), keys respond only to a hot direction ``a`` that ordinary
    embeddings have projected out — ordinary traffic gets zero scores
    (uniform attention), hot tokens get distinct softmax weights
    ``w in {4, 1, 3, 2}`` solved from their embedding's ``a`` component;
  * values carry a payload ``±g1 * nu`` whose *weighted sum cancels
    exactly* (4 + 1 = 3 + 2 with opposite payload signs): the true
    attention output is ordinary-sized, but a low-mode step truncates the
    four distinct softmax weights independently, leaving an error of order
    ``payload * 2^-8`` at M8 (and ``* 2^-16`` at M16) that the widened
    output projection ``wo += Mo * outer(nu, rho)`` amplifies into the
    logits;
  * every natural signal path through attention is shrunk (``wv * 0.02``)
    so ordinary tokens' probe error stays near the model-wide M8 floor.

The doctoring (:func:`condition_params`) is NumPy on the parameters' values
and independent of how they were drawn: :func:`conditioned_model` applies
it to the port's own ``init`` from a CPU generator seeded 0, and the same
function applied to the reference's undoctored parameters gives the
reference's doctored ones bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.precision import Mode
from repro_torch.models import build_model
from repro_torch.serve.scheduler import Request

#: softmax weight (w) and payload sign per hot token: sum(w+) == sum(w-)
_HOT_WEIGHTS = ((4.0, +1), (1.0, +1), (3.0, -1), (2.0, -1))


@dataclasses.dataclass
class ConditionedWorkload:
    """A doctored model + the token vocabulary split driving it."""

    cfg: object
    model: object
    params: dict
    hot_ids: tuple[int, ...]  # ids that manufacture cancellation
    safe_vocab: int  # ordinary prompts draw from [0, safe_vocab)

    def hot_prompt(self, rng: np.random.Generator, length: int = 6) -> np.ndarray:
        ids = list(self.hot_ids)
        pad = rng.integers(0, self.safe_vocab,
                           max(length - len(ids), 0)).tolist()
        return np.asarray(pad[:1] + ids + pad[1:], np.int32)

    def normal_prompt(self, rng: np.random.Generator, length: int = 6) -> np.ndarray:
        return rng.integers(0, self.safe_vocab, length).astype(np.int32)

    def requests(self, n: int, hot: set[int] | frozenset[int],
                 rng: np.random.Generator, *, prompt_len: int = 6,
                 max_new: int = 8) -> list[Request]:
        """n requests with rids 0..n-1; rids in ``hot`` get hot prompts."""
        return [
            Request(
                prompt=(self.hot_prompt(rng, prompt_len) if i in hot
                        else self.normal_prompt(rng, prompt_len)),
                max_new=max_new, rid=i,
            )
            for i in range(n)
        ]


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def conditioned_config(arch: str = "qwen1.5-0.5b", *, mode: Mode = Mode.M8,
                       width: int | None = None):
    """The doctored model's config: ``arch``'s smoke config cut to one layer,
    ``rope_theta`` 1e9, the policy's default at ``mode``; ``width``
    overrides d_model (d_ff = 2x, 4 heads over 2 kv heads)."""
    cfg = get_smoke_config(arch)
    if not cfg.qkv_bias:
        raise ValueError("conditioned_model needs an arch with qkv_bias "
                         "(the constant-query construction uses b_q)")
    # huge rope_theta: the slow-dim key direction is position-invariant, so
    # all hot keys coincide and their softmax weights come out exactly as
    # solved below
    over = {}
    if width is not None:
        over = dict(d_model=width, d_ff=2 * width, n_heads=4, n_kv_heads=2,
                    head_dim=width // 4)
    return dataclasses.replace(
        cfg, n_layers=1, rope_theta=1e9,
        policy=PrecisionPolicy(default=Mode(mode)), **over,
    )


def condition_params(cfg, params: dict, *, payload_gain: float = 40.0,
                     score_offset: float = 3.0, n_hot: int = 8, seed: int = 7,
                     value_gain: float = 1.0) -> tuple[int, ...]:
    """Doctor ``params`` (the 1-layer model of ``cfg``) in place, as the
    module docstring describes, and return the hot token ids.  Every
    tensor is replaced by a float32 tensor on its old device."""
    d, hkv, hq, hd = cfg.d_model, cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    half = hd // 2
    rng = np.random.default_rng(seed)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def put(old: torch.Tensor, value: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(value.astype(np.float32))).to(old.device)

    a = _unit(rng.normal(size=(d,)))  # key-exciting direction (hot only)
    c = rng.normal(size=(d,)); c -= (c @ a) * a; c = _unit(c)  # payload sign
    kap = np.zeros((hkv, hd)); kap[:, half - 1] = 1.0; kap[:, hd - 1] = 1.0
    kappa = _unit(kap.reshape(-1))  # slow-RoPE dims of every kv head
    kq = np.zeros((hq, hd)); kq[:, half - 1] = 1.0; kq[:, hd - 1] = 1.0
    kappa_q = _unit(kq.reshape(-1))
    nu = _unit(rng.normal(size=(hkv * hd,)))  # value payload direction

    seg = next(iter(params["layers"]))
    attn = params["layers"][seg]["attn"]
    mq = mk = 2.7
    g0, g1 = 0.3, float(value_gain)
    attn["wq"]["w"] = torch.zeros_like(attn["wq"]["w"])
    bq = host(attn["wq"]["b"]).copy()
    bq[0] = mq * kappa_q
    attn["wq"]["b"] = put(attn["wq"]["b"], bq)
    attn["wk"]["w"] = put(attn["wk"]["w"], (mk * np.outer(a, kappa))[None])
    wv0 = host(attn["wv"]["w"])[0]
    attn["wv"]["w"] = put(attn["wv"]["w"], (0.02 * wv0 + g1 * np.outer(c, nu))[None])
    rho = rng.normal(size=(d,))
    rho -= (rho @ a) * a; rho -= (rho @ c) * c; rho = _unit(rho)
    nu_q = np.broadcast_to(
        nu.reshape(hkv, hd), (hkv, hq // hkv, hd)).reshape(-1)
    wo = host(attn["wo"]["w"]).copy()
    wo[0] += payload_gain * np.outer(nu_q, rho)
    attn["wo"]["w"] = put(attn["wo"]["w"], wo)

    emb = host(params["embed"]["w"]).copy()
    emb = emb - np.outer(emb @ a, a) - np.outer(emb @ c, c)
    hot_ids = tuple(range(cfg.vocab - n_hot, cfg.vocab))
    # score per unit of embedding a-component (two slow dims per head, rms
    # norm maps a unit embedding onto a sqrt(d)-length direction)
    k_score = (mq * mk / (np.sqrt(hd) * np.sqrt(2 * hq) * np.sqrt(2 * hkv))
               * 2) * np.sqrt(d)
    for i, t in enumerate(hot_ids):
        w, sgn = _HOT_WEIGHTS[i % len(_HOT_WEIGHTS)]
        f = (score_offset + np.log(w)) / k_score
        h = np.sqrt(max(1.0 - f * f - g0 * g0, 1e-4))
        b = rng.normal(size=(d,))
        b -= (b @ a) * a; b -= (b @ c) * c
        emb[t] = f * a + sgn * g0 * c + h * _unit(b)
    params["embed"]["w"] = put(params["embed"]["w"], emb)
    return hot_ids


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def conditioned_model(
    arch: str = "qwen1.5-0.5b",
    *,
    mode: Mode = Mode.M8,
    payload_gain: float = 40.0,
    score_offset: float = 3.0,
    n_hot: int = 8,
    seed: int = 7,
    width: int | None = None,
    value_gain: float = 1.0,
    device=None,
) -> ConditionedWorkload:
    """Build the doctored 1-layer model (see module docstring) on
    ``device`` (None: the GPU, raising when there is none).  The base
    weights are ``init`` from a CPU generator seeded 0, so every device
    serves the same parameters.

    ``mode`` sets the model policy's default RMPM mode — the static
    operating point the adaptation loop starts from.  ``payload_gain`` (the
    ``Mo`` output-projection amplifier) scales the hot error signal
    relative to the ordinary-traffic floor.  ``width`` overrides d_model
    (d_ff = 2x, head_dim scaled to keep 4 heads): tests keep the fast smoke
    width; wider GEMMs make limb passes, not launches, the step's cost.
    """
    cfg = conditioned_config(arch, mode=mode, width=width)
    model = build_model(cfg, device=device)
    # drawn on the CPU whatever the device: the same model everywhere
    params = _to_device(model.init(torch.Generator().manual_seed(0)), model.device)
    hot_ids = condition_params(cfg, params, payload_gain=payload_gain,
                               score_offset=score_offset, n_hot=n_hot,
                               seed=seed, value_gain=value_gain)
    return ConditionedWorkload(
        cfg=cfg, model=model, params=params, hot_ids=hot_ids,
        safe_vocab=cfg.vocab - n_hot,
    )
