"""Masked-conv kernel times of two checkouts on one GPU, in turns (A, B, B,
A), so that a kernel change is compared with its parent on the same card:

    python3 scripts/ab_kernel_times.py PARENT_DIR [--dtype float32|bfloat16]
        [--batch 1 [8 ...]]

PARENT_DIR is an unpacked checkout of the other commit (``git archive``
into a git-ignored directory); this checkout is B. Each turn is a fresh
process that builds its tree's kernel (printing ptxas' register and
serialisation notes) and runs ``chip_smoke.phase_kernel_times`` at each
batch size (default 1): CUDA events over 20 calls per stage behind a cold
L2, weights packed before the timed window. It prints each turn's
per-stage lines and its sum over the 13 launches of a 1024^2 swap pass.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CODE = ("import torch, chip_smoke as cs; torch.backends.cuda.matmul.allow_tf32 = False; "
        "torch.backends.cudnn.allow_tf32 = False; cs.phase_build(); dt = torch.{dt}\n"
        "for b in {batches}:\n"
        "    rows = cs.phase_kernel_times(b, dt) if cs.phase_kernel_times.__code__.co_argcount > 1 "
        "else cs.phase_kernel_times()\n"
        "    cs._per_swap_line(rows, 13, b, dt) if cs._per_swap_line.__code__.co_argcount > 3 "
        "else cs._per_swap_line(rows, 13)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent_dir")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, nargs="+", default=[1])
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"A": os.path.abspath(args.parent_dir), "B": here}
    for name in ("A", "B", "B", "A"):
        res = subprocess.run([sys.executable, "-c", CODE.format(dt=args.dtype, batches=args.batch)],
                             cwd=trees[name], capture_output=True, text=True)
        for line in (res.stdout + res.stderr).splitlines():
            if "Performance Loss" in line or "registers" in line or "[time]" in line:
                print(f"{name} {line}", flush=True)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-3000:], flush=True)
            raise SystemExit(f"FAIL: turn {name} exited {res.returncode}")


if __name__ == "__main__":
    main()
