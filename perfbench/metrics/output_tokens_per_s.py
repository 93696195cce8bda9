"""Every token that reached the host in the window, over its seconds."""
from harness import window

LAYER = None
MOVES = None


def read(run):
    return window.output_tokens_per_s(run.timeline)
