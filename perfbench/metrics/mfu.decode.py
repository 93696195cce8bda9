"""The decode steps' share of the chip's bf16 peak: the model's own FLOPs for
the window's decode steps (2 x active parameters a row, attention over each
row's real context; no limb pass counted) over the engine's ``decode_step``
spans' wall time x 989 TFLOP/s."""
from harness import window, work

LAYER = "model"
MOVES = "output_tokens_per_s"


def read(run):
    tl, sz = run.timeline, run.sizes
    flops = wall = 0.0
    for (st, ctx), span in zip(window.decode_contexts(tl), run.decodes, strict=True):
        if tl.t_open <= span.t0 and span.t1 <= tl.t_close:
            flops += work.decode_flops(run.cell.family, sz, ctx)
            wall += span.t1 - span.t0
    return 100.0 * flops / (wall * work.PEAK_FLOPS) if wall else None
