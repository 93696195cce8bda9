"""The median host wall of the window's ``step()`` calls that admit nothing:
one decode step each, ending when its tokens reach the host."""
from harness import window

LAYER = "engine"
MOVES = "output_tokens_per_s"


def read(run):
    return window.median(window.decode_only_step_ms(run.timeline))
