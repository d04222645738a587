"""The measured window of a closed loop, and its arithmetic.

One client sends requests back to back.  The window opens at the start of
the first request after warm-up and closes at the end of the first request
that ends at or after ``seconds``: a rate is all the items the window's
requests finished over its exact length, and a tail is taken over every
request in it, each timed from its start to its end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, List, Sequence


@dataclass
class Request:
    start: float          # host seconds
    end: float
    items: int
    frame: int
    answer: Any = field(default=None, repr=False)

    @property
    def latency(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    requests: List[Request]

    @property
    def opened(self) -> float:
        return self.requests[0].start

    @property
    def closed(self) -> float:
        return self.requests[-1].end

    @property
    def seconds(self) -> float:
        return self.closed - self.opened

    @property
    def items(self) -> int:
        return sum(r.items for r in self.requests)

    def rate(self) -> float:
        """Items finished per second over the whole window."""
        return self.items / self.seconds

    def latency_quantile(self, q: float) -> float:
        """The q-quantile of every request's latency, linear between the
        two nearest ranks."""
        return quantile([r.latency for r in self.requests], q)


def quantile(values: Sequence[float], q: float) -> float:
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def closed_loop(send: Callable[[int], Any], frames: Sequence[int],
                items: int, seconds: float, clock: Callable[[], float],
                after: Callable[[Request], None] = None) -> Window:
    """Send ``frames`` in turn, cycling, each request when the one before
    it has ended (``send`` returns once its answer is complete), until a
    request ends ``seconds`` or more after the first one started.
    ``after`` sees each request as it ends."""
    requests: List[Request] = []
    k = 0
    while True:
        frame = frames[k % len(frames)]
        t0 = clock()
        answer = send(frame)
        t1 = clock()
        req = Request(start=t0, end=t1, items=items, frame=frame,
                      answer=answer)
        requests.append(req)
        if after is not None:
            after(req)
        k += 1
        if t1 - requests[0].start >= seconds:
            return Window(requests)
