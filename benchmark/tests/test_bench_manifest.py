"""BENCHMARK.json against the benchmark's contract, every name resolved,
a cell made of new files only, and the inputs' dependence on the seed."""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness.manifest import (  # noqa: E402
    cell_layers,
    entry_module,
    layer_specs,
    load_manifest,
    metric_reader,
    resolve_cell,
    system_module,
)
from benchmark.harness.traffic import make_pool  # noqa: E402

M = load_manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
CELLS = [w["name"] for w in M["workloads"]]
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|projection|head|"
                   r"expansion|channel|feat|size)")


def _line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_text():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in M["per_layer"]:
        assert _line(m["layer"])


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports(cell):
    c = resolve_cell(M, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert c.config["name"] == next(w["config"] for w in M["workloads"] if w["name"] == cell)
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_reader(m["name"]))
    system = system_module(c.config)
    assert all(callable(getattr(system, f)) for f in ("build", "Watch", "check", "readings"))
    entry = entry_module(c.traffic)
    assert callable(entry.Calls) and callable(entry.call) and callable(entry.result)
    assert cell_layers(c)


def test_every_per_layer_metric_moves_what_its_cells_report():
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for cell in m.get("workloads", CELLS):
            reported = {e["name"] for e in resolve_cell(M, cell).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)


def test_config_files_keep_the_published_widths():
    for c in M["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == {"dtype": "float32", "cuda.matmul.allow_tf32": False,
                                    "cudnn.allow_tf32": False}
        assert cfg["flops_per_image"] > 1e11
        assert set(cfg["check"]["limits"])


def test_layers_resolve_to_the_ports_entry_points():
    import importlib

    names = [p.stem for p in sorted((ROOT / "benchmark" / "layers").glob("*.py"))]
    for spec in layer_specs(names):
        where, _, path = spec["target"].partition(":")
        if where == "system":
            continue
        owner = importlib.import_module(where)
        for p in path.split("."):
            owner = getattr(owner, p)
        assert callable(owner), spec


def test_a_cell_of_new_files_runs_through_the_loader(tmp_path):
    """A new configuration, mix and cell as new files and entries (the
    tiny tree) resolve and run one short window on the CPU."""
    import time

    import torch

    from benchmark.harness import cell
    from benchmark.tests.tiny import make_tree

    torch.set_num_threads(2)
    bench = make_tree(tmp_path)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    res, table, _ = cell.run("swap.batch", 3, 0.5, False, time.perf_counter(),
                             device="cpu", root=tmp_path, bench_dir=bench)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    assert list(res)[-1] == "check"
    assert resolve_cell(m, "reenact.single", tmp_path, bench).config["chain"]


IDENTITY = '''
"""A system that gives back each target unchanged."""
import torch


class Identity:
    def swap_batch(self, src_u8, tgt_u8, chunk):
        return tgt_u8


def build(config, seed, device, phases=None):
    return Identity(), 0.0


class Watch:
    def __init__(self, system):
        pass

    def take(self):
        return True

    def remove(self):
        pass


def check(config, seed, samples, calls, device, checksum):
    wrong = sum(int((got != calls.inputs(i)[1]).any()) for i, got in samples)
    return {"wrong_images": wrong}, True
'''


def test_a_cell_of_another_system_is_new_files_only(tmp_path):
    """A configuration that names a system of its own, and its cell, run
    through the harness from new files and manifest entries alone."""
    import time

    from benchmark.harness import cell
    from benchmark.tests.tiny import make_tree

    bench = make_tree(tmp_path)
    (bench / "systems").unlink()
    (bench / "systems").mkdir()
    (bench / "systems" / "identity.py").write_text(IDENTITY)
    cfg = {"name": "tiny-identity", "system": "identity", "net3": {"out_size": 32},
           "precision": {"dtype": "float32", "cuda.matmul.allow_tf32": False,
                         "cudnn.allow_tf32": False},
           "check": {"limits": {"wrong_images": 0}}}
    (bench / "configs" / "tiny-identity.json").write_text(json.dumps(cfg))
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-identity", "source": "tiny", "reduced": [],
                         "file": "benchmark/configs/tiny-identity.json", "why": "tiny"})
    m["workloads"].append({"name": "identity.batch", "config": "tiny-identity",
                           "traffic": "tbatch", "chips": 1, "why": "tiny"})
    for metric in m["end_to_end"]:
        if metric["name"] == "images_per_s":
            metric["workloads"].append("identity.batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    res, table, _ = cell.run("identity.batch", 7, 0.2, False, time.perf_counter(),
                             device="cpu", root=tmp_path, bench_dir=bench)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    assert ["wrong_images", 0, 0] in table


def test_a_new_layer_is_installed_only_where_a_metric_reads_it(tmp_path):
    """A layer file whose target the old cells' system lacks changes
    nothing for them: a cell installs the layers of its own metrics and
    entry point only."""
    import time

    import torch

    from benchmark.harness import cell
    from benchmark.tests.tiny import make_tree

    torch.set_num_threads(2)
    bench = make_tree(tmp_path)
    (bench / "layers").unlink()
    (bench / "layers").mkdir()
    for f in (ROOT / "benchmark" / "layers").glob("*.py"):
        (bench / "layers" / f.name).write_text(f.read_text())
    (bench / "layers" / "elsewhere.py").write_text(
        'SPAN = "elsewhere"\nTARGET = "system:no_such_method"\n')
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    c = resolve_cell(m, "swap.batch", tmp_path, bench)
    assert {s["name"] for s in cell_layers(c, bench)} == {
        "swap_batch_call", "fused_swap", "encoder", "synthesis", "masked_conv"}
    res, _, _ = cell.run("swap.batch", 3, 0.2, True, time.perf_counter(), device="cpu",
                         root=tmp_path, bench_dir=bench)
    assert res["correct"] and res["failed"] == 0 and "breakdown" in res


@pytest.mark.parametrize("mix", ["single", "batch8"])
def test_the_seed_fixes_the_pool(mix):
    bench = ROOT / "benchmark"
    params = json.loads((bench / "traffic" / f"{mix}.json").read_text())
    params["pool"] = 4

    a, b, c = (np.concatenate(make_pool(params, 128, s, bench))
               for s in (2**31 + 11, 2**31 + 11, 2**31 + 12))
    assert np.array_equal(a, b)
    assert a.shape == c.shape == (8, 3, 128, 128) and a.dtype == c.dtype == np.uint8
    assert all(not np.array_equal(x, y) for x, y in zip(a, c))
