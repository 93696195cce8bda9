"""The share of the profiled span in which no device operation ran, from
``torch.profiler``'s device timeline."""
LAYER = "device"
MOVES = "output_tokens_per_s"


def read(run):
    dt = run.device_trace
    return None if dt is None else 100.0 * (1.0 - dt.busy_s() / dt.window_s)
