"""What the harness does with a system's check: the worst of each number
over the sampled results, judged against the configuration's limits.
``correct`` needs no failed call, the weights drawn again to match those
the system got, and every number at or under its limit. The numbers
themselves are the system's (``systems/<system>.py``)."""

from __future__ import annotations


def worst(rows) -> dict:
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(every number within its limit, [[name, value, limit], ...])."""
    table = [[k, numbers.get(k), lim] for k, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in table)
    return ok, table
