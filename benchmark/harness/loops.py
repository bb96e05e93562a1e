"""The closed loop: one client calls the mix's entry point
(``entries/<entry>.py``) back to back.

A call is timed on the host clock from the call to its return, which holds
the downloaded result. It fails when it raises, when its result has the
wrong shape or dtype, or when the system's watch (``systems/<system>.py``,
read after the clock stops) saw a non-finite output.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``k`` calls of a stream of unknown length, drawn
    from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 1])
        self.slots = [None] * k
        self.n = 0

    def wants(self) -> int:
        """The slot the next call takes, or -1."""
        i, self.n = self.n, self.n + 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else -1

    def put(self, slot: int, item):
        self.slots[slot] = item

    def sample(self):
        return [s for s in self.slots if s is not None]


class Loop:
    """Calls in order from ``start``; records latency, completion, failures
    and a seeded sample of (call index, result) for the check."""

    def __init__(self, system, calls, entry, watch, sample: Reservoir):
        self.system, self.calls, self.entry = system, calls, entry
        self.watch, self.sample = watch, sample
        self.latency_s, self.done_at = [], []
        self.attempted = self.failed = self.images = 0
        self.errors = []

    def one(self, i: int):
        self.attempted += 1
        t0 = time.perf_counter()
        try:
            out = self.entry.call(self.system, self.calls.args(i), self.calls.mix)
        except Exception:  # a failed request is counted, the loop goes on
            self.failed += 1
            self.errors.append(traceback.format_exc(limit=3))
            self.watch.take()
            return
        t1 = time.perf_counter()
        try:
            arr = self.entry.result(self.calls, out)
        except ValueError as e:
            self.failed += 1
            self.errors.append(str(e))
            self.watch.take()
            return
        if not self.watch.take():
            self.failed += 1
            self.errors.append(f"call {i}: non-finite output")
            return
        self.latency_s.append(t1 - t0)
        self.done_at.append(t1)
        self.images += self.calls.per_call
        slot = self.sample.wants()
        if slot >= 0:
            self.sample.put(slot, (i, arr.copy()))

    def run_for(self, seconds: float, start: int = 0) -> tuple:
        """Calls until ``seconds`` have passed; (window start, calls made)."""
        t_start = time.perf_counter()
        i = start
        while time.perf_counter() - t_start < seconds:
            self.one(i)
            i += 1
        return t_start, i - start

    def run_n(self, n: int, start: int = 0):
        for i in range(start, start + n):
            self.one(i)


def warm_up(system, calls, entry, n: int):
    """``n`` calls of the cell's own shapes, outside any window."""
    for i in range(n):
        entry.result(calls, entry.call(system, calls.args(i), calls.mix))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
