"""The two readings each limit of ``correct`` is set from, on the chip at
a cell's own sizes (not run by the benchmark's own runs).

For each seed: the system runs the first ``check_calls`` calls of the
cell's mix through its timed entry point after the warm-up and is freed;
then the configuration's system module (``systems/<system>.py``,
``readings``) compares its results with the plain reference's (the
program's reading) and the reference computed at the precision below the
configuration's with the reference as stated (the control's reading).
Every seed in one process.

    python benchmark/readings.py --workload <cell> --seeds 1 2 3 [--out FILE]
"""

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.cell import set_precision
    from benchmark.harness.loops import Loop, Reservoir, warm_up
    from benchmark.harness.manifest import (
        entry_module,
        load_manifest,
        resolve_cell,
        system_module,
    )

    cell = resolve_cell(load_manifest(ROOT), a.workload)
    config, mix = cell.config, cell.traffic
    system_mod, entry = system_module(config), entry_module(mix)
    rows = []
    for seed in a.seeds:
        set_precision(config["precision"])
        t0 = time.perf_counter()
        calls = entry.Calls(mix, config, seed, ROOT / "benchmark", tempfile.mkdtemp(), a.device)
        n = mix["check_calls"]
        system, _ = system_mod.build(config, seed, a.device)
        watch = system_mod.Watch(system)
        warm_up(system, calls, entry, mix["warmup"])
        watch.take()
        loop = Loop(system, calls, entry, watch, Reservoir(n, seed))
        loop.run_n(n)
        watch.remove()
        del system, watch
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        row = {"seed": seed, "failed": loop.failed}
        row.update(system_mod.readings(config, seed, loop.sample.sample(), calls, a.device))
        row["seconds"] = time.perf_counter() - t0
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
