"""The window's arithmetic on synthetic timelines."""
import numpy as np
import pytest

from harness import window
from harness.drive import Step, Timeline


def timeline(tokens: dict, due: dict, t_open=10.0, t_close=20.0, submitted=None):
    tl = Timeline(t_open=t_open, t_close=t_close)
    for rid, ts in tokens.items():
        tl.prompts[rid] = np.zeros(8, np.int32)
        tl.max_new[rid] = len(ts)
        tl.tokens[rid] = [0] * len(ts)
        tl.token_t[rid] = list(ts)
        tl.due[rid] = due[rid]
        tl.submitted[rid] = (submitted or due)[rid]
    return tl


def test_tokens_per_s_counts_only_the_window():
    tl = timeline({0: [9.0, 11.0, 12.0], 1: [19.5, 20.0, 20.5]}, {0: 8.0, 1: 19.0})
    assert window.output_tokens(tl) == 4
    assert window.output_tokens_per_s(tl) == pytest.approx(0.4)


def test_gaps_pool_all_requests_with_both_ends_inside():
    tl = timeline({0: [9.0, 11.0, 12.0, 12.5], 1: [15.0, 18.0, 21.0]}, {0: 8.0, 1: 14.0})
    assert sorted(window.token_gaps_ms(tl)) == pytest.approx([500.0, 1000.0, 3000.0])
    assert window.percentile(list(range(1, 101)), 90) == 90
    assert window.percentile(list(range(1, 101)), 95) == 95
    assert window.percentile([], 50) is None


def test_ttft_from_the_due_time_and_waiting_requests_count():
    # rid 0 was due at 11 but handed over at 12.5 (a stalled step): the wait
    # counts; rid 1 is still waiting at the close; rid 2 was due before the
    # window opened
    tl = timeline({0: [13.0, 13.5], 1: [], 2: [10.5]}, {0: 11.0, 1: 17.0, 2: 9.0},
                  submitted={0: 12.5, 1: 17.0, 2: 9.0})
    assert sorted(window.ttft_ms(tl)) == pytest.approx([2000.0, 3000.0])
    assert sorted(window.arrival_lag_ms(tl)) == pytest.approx([0.0, 1500.0])


def test_a_stall_shows_in_the_tail():
    """One long step delays every request due during it: the 90th
    percentile moves though the median does not."""
    due = {i: 10.0 + 0.1 * i for i in range(40)}
    quick = {i: [d + 0.05] for i, d in due.items()}
    stalled = dict(quick)
    for i in range(30, 40):  # due during a 1 s stall from 13.0
        stalled[i] = [14.0 + 0.05 * (i - 30)]
    a = window.ttft_ms(timeline(quick, due))
    b = window.ttft_ms(timeline(stalled, due))
    assert window.median(a) == pytest.approx(window.median(b))
    assert window.percentile(b, 90) > 5 * window.percentile(a, 90)


def test_decode_only_steps_and_contexts():
    tl = timeline({0: [11.0, 11.1, 11.2], 1: [11.1, 11.2]}, {0: 10.5, 1: 10.6})
    tl.steps = [Step(10.9, 11.0, [0], [0][:0]), Step(11.0, 11.1, [1], [0]),
                Step(11.1, 11.2, [], [0, 1])]
    assert window.decode_only_step_ms(tl) == pytest.approx([100.0])
    ctx = window.decode_contexts(tl)
    assert [c for _, c in ctx] == [[9], [10, 9]]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Engine:
    """Always busy; each step admits what was submitted (its first token at
    the step's end) and lasts 0.5 s, but the step that starts at 9.5 s runs
    3.5 s, to 3 s past a 10-s window."""

    def __init__(self, clock):
        self.clock, self.waiting, self.scheduler = clock, [], self

    def has_work(self):
        return True

    def submit(self, req):
        self.waiting.append(req)

    def step(self):
        self.clock.t += 3.5 if self.clock.t == 9.5 else 0.5
        out, self.waiting = [(rid, 1) for rid in self.waiting], []
        return out


class _Load:
    closed = False

    def __init__(self):
        self.times = [0.25 * i for i in range(1, 60)]

    def due(self, t):
        out = []
        while self.times and self.times[0] <= t:
            out.append((self.times.pop(0), np.zeros(4, np.int32), 1))
        return out

    def next_due(self):
        return self.times[0] if self.times else None


def test_arrivals_during_a_step_past_the_close_count():
    """Requests due while the last step runs past the close are never handed
    to the engine; each still enters the tail at what it waited by then."""
    from harness.drive import Driver

    clock = _Clock()
    drv = Driver(_Engine(clock), _Load(), lambda p, n, rid: rid, clock=clock)
    drv.window(10.0)
    tl = drv.tl
    assert tl.t_close == pytest.approx(13.0)
    unsent = sorted(rid for rid in tl.due if rid not in tl.submitted)
    late = [9.75 + 0.25 * i for i in range(13)]  # due in the window, never sent
    assert [tl.due[r] for r in unsent] == pytest.approx(late + [13.0])
    ttft = window.ttft_ms(tl)
    assert len(ttft) == 51  # due 0.25 .. 12.75
    # due at 9.25 and 9.5: sent before the long step, first token at 13.0
    assert sorted(ttft)[-2:] == pytest.approx([3500.0, 3750.0])
    for d in late:
        assert (13.0 - d) * 1e3 == pytest.approx(min(ttft, key=lambda v: abs(v - (13.0 - d) * 1e3)))
    assert sorted(window.arrival_lag_ms(tl))[-1] == pytest.approx(3250.0)
