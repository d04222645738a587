"""The window's arithmetic on synthetic clocks."""

from __future__ import annotations

import pytest

from portbench.window import closed_loop, quantile


class Clock:
    """A clock that a request advances by its own duration."""

    def __init__(self, durations):
        self.t = 100.0
        self.durations = list(durations)
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.t

    def send(self, frame):
        self.t += self.durations.pop(0)
        return frame


def test_window_ends_at_a_request_end():
    clock = Clock([1.2] * 10)
    win = closed_loop(clock.send, [0, 1, 2], items=8, seconds=3.0,
                      clock=clock)
    # 1.2, 2.4, 3.6: the third request is the first to end at or after 3 s
    assert len(win.requests) == 3
    assert win.seconds == pytest.approx(3.6)
    assert win.items == 24
    assert win.rate() == pytest.approx(24 / 3.6)
    assert [r.frame for r in win.requests] == [0, 1, 2]


def test_nothing_lost_at_the_boundary():
    # a long last request counts whole, and the length is exact
    clock = Clock([0.5, 0.5, 0.5, 2.0, 0.5])
    win = closed_loop(clock.send, [7], items=1, seconds=1.6, clock=clock)
    assert len(win.requests) == 4
    assert win.seconds == pytest.approx(3.5)
    assert win.rate() == pytest.approx(4 / 3.5)


def test_rate_counts_the_gaps_between_requests():
    t = {"now": 0.0}

    def clock():
        t["now"] += 0.25          # host time between and around requests
        return t["now"]

    win = closed_loop(lambda f: f, [0], items=2, seconds=1.0, clock=clock)
    assert win.opened == 0.25
    assert win.rate() == pytest.approx(win.items / (win.closed - 0.25))


def test_frames_cycle():
    clock = Clock([1.0] * 7)
    win = closed_loop(clock.send, [4, 5], items=1, seconds=6.5, clock=clock)
    assert [r.frame for r in win.requests] == [4, 5, 4, 5, 4, 5, 4]


def test_p95_over_every_request():
    lat = [0.1] * 95 + [1.0] * 5
    clock = Clock(lat)
    win = closed_loop(clock.send, [0], items=1, seconds=sum(lat) - 1e-9,
                      clock=clock)
    assert len(win.requests) == 100
    assert win.latency_quantile(0.95) == pytest.approx(
        quantile(lat, 0.95))
    assert win.latency_quantile(0.95) == pytest.approx(0.1 + 0.05 * 0.9)
    assert win.latency_quantile(1.0) == pytest.approx(1.0)


@pytest.mark.parametrize("values,q,want", [
    ([3.0], 0.95, 3.0),
    ([1.0, 2.0], 0.5, 1.5),
    ([4.0, 1.0, 3.0, 2.0], 0.0, 1.0),
    ([4.0, 1.0, 3.0, 2.0], 1.0, 4.0),
])
def test_quantile(values, q, want):
    assert quantile(values, q) == pytest.approx(want)
