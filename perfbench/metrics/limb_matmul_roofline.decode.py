"""The limb kernel's share of its roofline in the profiled decode steps: the
sum of each launch's bound (the larger of the mode's passes x 2MKN over 989
TFLOP/s and the f32 operands read once plus the output written once over
3.35 TB/s; M = the slot array) over the device time of the kernel's
launches (its body and split-K reduction) inside the engine's
``decode_step`` spans, from ``torch.profiler``."""
from harness import trace, work

LAYER = "kernels"
MOVES = "output_tokens_per_s"


def read(run):
    dt = run.device_trace
    if dt is None:
        return None
    spans = [s for s in run.decodes if dt.t0 <= s.t0 and s.t1 <= dt.t1]
    device = dt.device_time(trace.is_limb_kernel, spans)
    bound = len(spans) * work.limb_bound_s(run.cell.family, run.sizes, run.traffic["slots"],
                                           run.mode)
    return 100.0 * bound / device if device else None
