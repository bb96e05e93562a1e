"""Spans around the port's layer entry points, installed from outside.

Each ``layers/<layer>.py`` names its SPAN and the TARGET it wraps: either
``"<dotted module>:<attribute path>"``, the attribute that callers look up
(a module-level function, or a method on its class), or
``"system:<attribute>"``, an attribute of the system object itself. The
wrapper opens a ``torch.profiler.record_function`` range of the span's name
around every call and, with HOST_CLOCK, keeps the host time of each call.
Nothing is recorded inside the program.
"""

from __future__ import annotations

import functools
import importlib
import time

import torch


def _resolve(target: str, system):
    where, _, path = target.partition(":")
    if where == "system":
        owner = system
    else:
        owner = importlib.import_module(where)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Spans:
    def __init__(self):
        self.host = {}  # span -> [seconds of each call]
        self._undo = []

    def install(self, specs, system):
        for spec in specs:
            owner, attr = _resolve(spec["target"], system)
            fn = getattr(owner, attr)
            times = self.host.setdefault(spec["span"], []) if spec["host_clock"] else None
            setattr(owner, attr, _wrap(fn, spec["span"], times))
            self._undo.append((owner, attr, fn))

    def uninstall(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def reset_host(self):
        for v in self.host.values():
            v.clear()


def _wrap(fn, span: str, times):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(span):
            if times is None:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times.append(time.perf_counter() - t0)
    return inner
