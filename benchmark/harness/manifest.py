"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs`` entry -> its ``file``) and a
traffic mix (``traffic/<mix>.json``). The configuration names its system
(``systems/<system>.py``: how the system under test is built, watched and
checked against its reference) and the mix its entry point
(``entries/<entry>.py``: the calls a client makes). A metric is read by
``metrics/<family>.py``, the family being the part of its name before the
first dot. A cell's layers (``layers/<layer>.py``) are those its entry
point and its per-layer metrics' readers name in ``LAYERS``. Adding a cell,
a configuration of another system, a mix, a layer or a metric family adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reported_by(metric: dict, cell_name: str) -> bool:
    wl = metric.get("workloads")
    return wl is None or cell_name in wl


def resolve_cell(manifest: dict, name: str, root: Path = ROOT,
                 bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration and mix read, and the
    metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reported_by(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer)


def _metric_module(metric_name: str, bench_dir: Path):
    family = metric_name.partition(".")[0]
    return _load_module(bench_dir / "metrics" / f"{family}.py",
                        f"benchmark_metric_{family}")


def metric_reader(metric_name: str, bench_dir: Path = BENCH_DIR):
    """``read(ctx, suffix)`` of ``metrics/<family>.py``."""
    mod = _metric_module(metric_name, bench_dir)
    suffix = metric_name.partition(".")[2]
    return lambda ctx: mod.read(ctx, suffix)


def system_module(config: dict, bench_dir: Path = BENCH_DIR):
    """``systems/<config["system"]>.py``."""
    name = config["system"]
    return _load_module(bench_dir / "systems" / f"{name}.py", f"benchmark_system_{name}")


def entry_module(mix: dict, bench_dir: Path = BENCH_DIR):
    """``entries/<mix["entry"]>.py``."""
    name = mix["entry"]
    return _load_module(bench_dir / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def cell_layers(cell: Cell, bench_dir: Path = BENCH_DIR) -> list:
    """The layers a cell's traced run installs: those its entry point and
    the readers of its per-layer metrics name in ``LAYERS``, in name
    order, no others (a layer that no metric of the cell reads is not
    installed, so a new layer cannot break an old cell)."""
    names = set(getattr(entry_module(cell.traffic, bench_dir), "LAYERS", ()))
    for m in cell.per_layer:
        names |= set(getattr(_metric_module(m["name"], bench_dir), "LAYERS", ()))
    return layer_specs(sorted(names), bench_dir)


def layer_specs(names, bench_dir: Path = BENCH_DIR) -> list:
    """``layers/<name>.py`` for each name: its SPAN name, the TARGET it
    wraps and, where it keeps the host time of each call, HOST_CLOCK."""
    out = []
    for name in names:
        mod = _load_module(bench_dir / "layers" / f"{name}.py", f"benchmark_layer_{name}")
        out.append({"name": name, "span": mod.SPAN, "target": mod.TARGET,
                    "host_clock": bool(getattr(mod, "HOST_CLOCK", False))})
    return out
