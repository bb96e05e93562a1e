"""Runs one cell of BENCHMARK.json on this machine's GPUs and prints its
result as the last line of standard output.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import torch

    from benchmark.harness import cell
    from benchmark.harness.manifest import load_manifest

    chips = next(w["chips"] for w in load_manifest(ROOT)["workloads"]
                 if w["name"] == a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, table, notes = cell.run(a.workload, a.seed, a.seconds, bool(a.trace),
                                     T_PROCESS)
    return cell.emit(result, table, notes)


if __name__ == "__main__":
    sys.exit(main())
