"""Inversion command line of the port (counterpart of
``scripts/optimization.py``): refines the style vectors of test sample 123
of CelebAMask-HQ (the reference's index), or of the synthetic faces when the
dataset is absent, and writes the results under ``--output_dir``:

    python -m e4s_tpu_torch.cli.optimization [--W_steps 200] \\
        [--opt_name adam] [--optimize_noise] [--bf16] \\
        [--save_intermediate --save_interval 50] [--output_dir DIR] \\
        [--device cuda]

Runs on the GPU unless ``--device cpu`` is given. Checkpoints that are not
found are replaced by seeded random weights (with a message).
"""

from __future__ import annotations

import os

from e4s_tpu_torch.options.optim_options import OptimOptions
from e4s_tpu_torch.pipelines.optimization import Optimizer

SAMPLE_IDX = 123


def main(argv=None):
    return run(OptimOptions().parse(argv))


def run(opts):
    """The inversion ``main`` runs, on parsed options."""
    os.makedirs(opts.output_dir, exist_ok=True)
    optimizer = Optimizer(opts, device=opts.device)
    result = optimizer.invertion(SAMPLE_IDX)
    print(f"Saved inversion results to {opts.output_dir}/sample_{SAMPLE_IDX}")
    return result


if __name__ == "__main__":
    main()
