"""Deciding ``correct``: the served tokens held against the plain reference.

Once the window has closed and the program's state is freed, the
reference (the ``Replay`` of the configuration's family) follows the run:
every prefill and decode step that touched a judged request, with the same
rows in the same order, fed the tokens the program served.  At every
served token it reads the gap by which that token's reference logit lies
below the reference's best; the widest gap is compared with the cell's
limit.

Which requests are judged turns on whether the rows of one step share
state (the family's ``coupled_rows``).  Independent rows (a dense model):
every request that holds a slot when the window opens (one a slot, so a
fault that hits some slots is seen), the one with the most served tokens,
and a sample drawn from the seed up to the mix's ``judge_requests``.
Coupled rows (a MoE model's rows share expert capacity within a decode
step): every request, and every step must hold every slot (a closed loop
keeps them full).
"""
from __future__ import annotations

import numpy as np
import torch

from harness import gen
from harness.drive import Timeline


def gap(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """By how much the served ``token``'s logit lies below the best:
    logits (..., V), token (...,) -> (...,) >= 0."""
    return logits.max(dim=-1).values - logits.gather(-1, token[..., None])[..., 0]


def judged(tl: Timeline, coupled: bool, n: int, seed: int) -> set[int]:
    served = [rid for rid, toks in tl.tokens.items() if toks]
    if coupled or n >= len(served):
        return set(served)
    first = next((st for st in tl.steps if st.t0 >= tl.t_open and (st.decode or st.admitted)),
                 None)
    keep = set(first.decode + first.admitted) if first else set()
    keep.add(max(served, key=lambda r: (len(tl.tokens[r]), -r)))
    rest = [r for r in served if r not in keep]
    k = min(max(n - len(keep), 0), len(rest))
    pick = gen.rng_for(seed, 3).choice(len(rest), k, replace=False)
    return keep | {rest[i] for i in pick}


@torch.no_grad()
def readings(tl: Timeline, rep, coupled: bool, slots: int, rids: set[int], device) -> dict:
    """The widest gap over every served token of ``rids``, how many tokens
    were judged, and the share whose token was the reference's best;
    ``rep`` is the family's ``Replay`` with ``slots`` rows."""
    fed = {}  # rid -> tokens the replay has taken in (prefill's first counted)
    gaps, agree = [], []

    def judge(logits, served):
        gaps.append(gap(logits, served))
        agree.append(logits.argmax(dim=-1) == served)

    def settle(rid):
        if fed[rid] == len(tl.tokens[rid]):
            rep.release(rid)
            del fed[rid]

    for st in tl.steps:
        for rid in st.admitted:
            if rid in rids:
                prompt = torch.as_tensor(tl.prompts[rid].astype(np.int64), device=device)
                logits = rep.prefill(rid, prompt)
                judge(logits[None], torch.tensor([tl.tokens[rid][0]], device=device))
                fed[rid] = 1
                settle(rid)
        rows = [rid for rid in st.decode if rid in rids]
        if not rows:
            continue
        if coupled and len(rows) != slots:
            raise RuntimeError(
                f"a decode step of coupled rows held {len(rows)} of {slots} judged rows: the "
                "reference cannot follow it")
        inp = torch.tensor([tl.tokens[r][fed[r] - 1] for r in rows], device=device)
        out = torch.tensor([tl.tokens[r][fed[r]] for r in rows], device=device)
        judge(rep.decode(rows, inp), out)
        for r in rows:
            fed[r] += 1
            settle(r)
    g = torch.cat(gaps)
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], device=g.device)).tolist()
    return {"widest_logit_gap": float(g.max()), "tokens_judged": int(g.numel()),
            "off_best_share": float(1.0 - torch.cat(agree).float().mean()),
            "gap_p50": q[0], "gap_p90": q[1], "gap_p99": q[2]}
