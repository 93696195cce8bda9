"""The median of every gap between two consecutive tokens of one request,
both in the window (gaps of all requests together)."""
from harness import window

LAYER = None
MOVES = None


def read(run):
    return window.percentile(window.token_gaps_ms(run.timeline), 50)
