"""Training command line of the port (counterpart of ``scripts/train.py``):

    python -m e4s_tpu_torch.cli.train --exp_dir DIR [--dataset_name synthetic] \\
        [--max_steps N] [--bf16] [--optim_name ranger] [--checkpoint_path CKPT] \\
        [--device cuda]
    torchrun --nproc_per_node 4 -m e4s_tpu_torch.cli.train --distributed ...

Writes ``DIR/opt.json``, the metrics log ``DIR/logs/metrics.jsonl`` and the
checkpoints ``DIR/checkpoints/*.pt`` (each loads into the swap through
``--checkpoint_path``). Runs on the GPU unless ``--device cpu`` is given;
``--distributed`` (or torchrun's ``WORLD_SIZE`` > 1) trains data-parallel,
one process per card. Missing StyleGAN2, IR-SE50 and parsing checkpoints
are replaced by seeded random weights (with a message).
"""

from __future__ import annotations

import json
import os

import torch.distributed as dist

from e4s_tpu_torch.options.train_options import TrainOptions
from e4s_tpu_torch.training.coach import Coach, init_distributed


def main(argv=None):
    return run(TrainOptions().parse(argv))


def run(opts, dataset=None):
    """What ``main`` runs, on parsed options; returns the Coach."""
    if opts.distributed or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        opts.device = init_distributed(opts.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(opts.exp_dir, exist_ok=True)
    if rank == 0:
        with open(os.path.join(opts.exp_dir, "opt.json"), "w") as f:
            json.dump(vars(opts), f, indent=2, sort_keys=True)
    coach = Coach(opts, dataset=dataset)
    if opts.checkpoint_path:
        coach.load_checkpoint(opts.checkpoint_path)
    coach.train()
    return coach


if __name__ == "__main__":
    main()
