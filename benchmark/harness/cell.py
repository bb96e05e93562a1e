"""One run of one cell: set-up, the window (or the traced stretch), the
check, and the result line."""

from __future__ import annotations

import gc
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark.harness import check as checking
from benchmark.harness.loops import Loop, Reservoir, warm_up
from benchmark.harness.manifest import (
    BENCH_DIR,
    ROOT,
    cell_layers,
    entry_module,
    load_manifest,
    metric_reader,
    resolve_cell,
    system_module,
)
from benchmark.harness.spans import Spans
from benchmark.harness.trace import profile_stretch

# top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "e4s_tpu")


@dataclass
class Ctx:
    """What the metric readers read."""
    config: dict
    traffic: dict
    setup_s: float = 0.0
    latency_s: list = field(default_factory=list)
    images: int = 0
    t_start: float = 0.0
    t_last: float = 0.0
    reduced: object = None
    host: dict = field(default_factory=dict)
    calls: int = 0


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_precision(precision: dict):
    """The configuration's TF32 flags, set before anything is built."""
    torch.backends.cuda.matmul.allow_tf32 = bool(precision["cuda.matmul.allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(precision["cudnn.allow_tf32"])


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device="cuda", root: Path = ROOT, bench_dir: Path = BENCH_DIR, fault=None):
    """Returns (the result dict, the check table [[name, value, limit]],
    the notes for stderr). ``fault(system)``, for the tests, breaks the
    system after it is built."""
    manifest = load_manifest(root)
    cell = resolve_cell(manifest, workload, root, bench_dir)
    config, mix = cell.config, cell.traffic
    system_mod = system_module(config, bench_dir)
    entry = entry_module(mix, bench_dir)
    layers = cell_layers(cell, bench_dir) if trace else []
    set_precision(config["precision"])
    workdir = tempfile.mkdtemp(prefix="e4s_bench_")
    phases = {"imports": time.perf_counter() - t_process}
    try:
        t = time.perf_counter()
        calls = entry.Calls(mix, config, seed, bench_dir, workdir, device)
        phases["input pool"] = time.perf_counter() - t
        system, checksum = system_mod.build(config, seed, device, phases)
        if fault is not None:
            fault(system)
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        watch = system_mod.Watch(system)
        spans = Spans()
        spans.install(layers, system)
        t = time.perf_counter()
        warm_up(system, calls, entry, mix["warmup"])
        watch.take()
        phases["warm-up"] = time.perf_counter() - t
        ctx = Ctx(config, mix)
        ctx.setup_s = time.perf_counter() - t_process
        loop = Loop(system, calls, entry, watch, Reservoir(mix["check_calls"], seed))
        if trace:
            spans.reset_host()
            ctx.reduced = profile_stretch(lambda: warm_up(system, calls, entry, 1),
                                          lambda: loop.run_n(mix["trace_calls"]),
                                          [s["span"] for s in layers])
            ctx.host = {k: list(v) for k, v in spans.host.items()}
            ctx.calls = mix["trace_calls"]
        else:
            ctx.t_start, _ = loop.run_for(seconds)
        ctx.latency_s, ctx.images = loop.latency_s, loop.images
        ctx.t_last = loop.done_at[-1] if loop.done_at else ctx.t_start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        watch.remove()
        spans.uninstall()
        del system, watch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        numbers, same_weights = system_mod.check(config, seed, loop.sample.sample(), calls,
                                                 device, checksum)
        within, table = checking.judge(numbers, config["check"]["limits"])
        phases["check (not set-up)"] = time.perf_counter() - t_check
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(within and same_weights and loop.failed == 0
                              and loop.images > 0),
              "attempted": loop.attempted, "failed": loop.failed,
              "metrics": metrics, "device": dev}
    if trace:
        r = ctx.reduced
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
        result["breakdown"] = {"device_ops": r.device_ops, "idle_gaps": r.idle_gaps}
    table.append(["weights_redrawn_equal", int(same_weights), 1])
    table.append(["failed_calls", loop.failed, 0])
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in table}
    notes = [f"{k} {v:.3f} s" for k, v in phases.items()] + loop.errors[:5]
    return result, table, notes


def emit(result: dict, table, notes) -> int:
    """Prints the notes (set-up phases, errors), then the compared numbers
    beside their limits as the last lines of stderr, and the result as the
    last line of stdout; 0, or non-zero without a result when a forbidden
    module is loaded."""
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for name, v, lim in table:
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
