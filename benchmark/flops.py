"""Prints the whole step's FLOPs per image of a configuration (its system
module's ``count_flops``), the number its file keeps as
``flops_per_image``.

    python benchmark/flops.py benchmark/configs/<config>.json [--device cuda]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--device", default="cpu")
    a = p.parse_args(argv)
    import torch

    from benchmark.harness.manifest import system_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = json.loads(Path(a.config).read_text())
    print(json.dumps({"config": config["name"], "flops_per_image":
                      system_module(config).count_flops(config, a.device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
