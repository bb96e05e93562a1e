"""The control: the plain reference put in the program's place and
computed with TF32 on (the precision below the configurations' f32) has to
come out not correct. On the card only, at each cell's own size, on one
seed and one call (``benchmark/readings.py`` takes the dozen seeds of the
limits); on a machine without a card each test skips."""

import json
import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import check  # noqa: E402
from benchmark.harness.manifest import (  # noqa: E402
    entry_module,
    load_manifest,
    resolve_cell,
    system_module,
)

CELLS = [w["name"] for w in load_manifest(ROOT)["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card (TF32 does not exist on the CPU)")
    cell = resolve_cell(load_manifest(ROOT), workload)
    config, mix = cell.config, cell.traffic
    seed = 2**31 + 17
    calls = entry_module(mix).Calls(mix, config, seed, ROOT / "benchmark",
                                    tempfile.mkdtemp(), "cuda")
    system_mod = system_module(config)
    ref = system_mod.Reference(config, seed, "cuda")
    src, tgt = calls.inputs(0)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        want = ref.outputs(src, tgt)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        low = ref.outputs(src, tgt)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    numbers = check.worst([system_mod.compare(a, b, t) for a, b, t in zip(low, want, tgt)])
    ok, table = check.judge(numbers, config["check"]["limits"])
    print(json.dumps({"workload": workload, "control": numbers}))
    assert not ok, table
