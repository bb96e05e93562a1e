"""Times the port's lazy R1 step through the StyleGAN2 discriminator on one
CUDA GPU and lists where its device time goes.

    python3 scripts/profile_torch_r1.py [--size 1024] [--batch 2]

The step is what ``Coach._d_r1_step`` runs: D(x), the penalty
E|grad_x D(x)|^2 with ``create_graph=True``, its backward into D's weights
(a double backward through every conv of D). Prints the warm ms per step,
the ms of D's plain forward and backward for comparison, and the
``torch.profiler`` table of one step by CUDA time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from e4s_tpu_torch.criteria.adv_loss import d_r1_loss  # noqa: E402
from e4s_tpu_torch.models.stylegan2 import Discriminator  # noqa: E402
from e4s_tpu_torch.pipelines.model_io import materialise  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    print(f"[r1] {torch.cuda.get_device_name(0)}, D {args.size}^2, batch {args.batch}")
    D = materialise(lambda: Discriminator(args.size), seed=1,
                    device="cuda").requires_grad_(True)
    x = torch.randn(args.batch, 3, args.size, args.size, device="cuda")

    def r1_step():
        img = x.detach().requires_grad_(True)
        pred = D(img)
        (10 * d_r1_loss(pred, img) + 0 * pred.sum()).backward()

    def plain_step():
        D(x).sum().backward()

    for label, fn in (("R1 step", r1_step), ("plain forward + backward", plain_step)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            fn()
        torch.cuda.synchronize()
        print(f"[r1] {label}: {(time.perf_counter() - t0) / args.steps * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r1_step()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


if __name__ == "__main__":
    main()
