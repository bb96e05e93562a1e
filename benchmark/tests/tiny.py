"""A tiny copy of the benchmark's tree for the CPU tests: the real
``layers/``, ``metrics/``, ``systems/``, ``entries/`` and faces, a narrow
configuration of each kind and small mixes, under a temporary root. Built
from new files only, as a later cell would be. ``narrow_sr()`` has the
port's restorer build RealESRNet with the tiny configuration's one block
(the published one has 23)."""

from __future__ import annotations

import contextlib
import functools
import json
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
S = 64  # image side of the tiny cells

NET3 = {"num_seg_cls": 12, "out_size": S, "remaining_layer_idx": 7, "split_layer_idx": 5,
        "n_styles": 10, "start_from_latent_avg": True, "encoder_size": S,
        "encoder_slim": True, "ch_div": 8, "channel_multiplier": 2, "style_dim": 512,
        "n_mlp": 8}
CHAIN = {"fv2v": {"size": 16,
                  "kp_kwargs": dict(block_expansion=8, max_features=64, reshape_channel=128,
                                    reshape_depth=4, num_blocks=2),
                  "gen_kwargs": dict(feature_channel=4, block_expansion=64, max_features=16,
                                     num_down_blocks=2, reshape_channel=4, reshape_depth=4,
                                     num_resblocks=1, dense_motion_params=dict(
                                         block_expansion=8, num_blocks=2, max_features=32))},
         "gpen": {"in_size": 32, "use_sr": True, "sr_scale": 4, "sr_num_block": 1,
                  "channel_multiplier": 2, "narrow": 0.125, "force_one_face": True}}
# the masked layers of the 64^2 generator with K = 7, channels / 8
LAUNCHES = [(4, 64, 64, False), (4, 64, 64, True), (8, 64, 64, False), (8, 64, 64, True),
            (16, 64, 64, False), (16, 64, 64, True), (32, 64, 64, False)]


@contextlib.contextmanager
def narrow_sr():
    import e4s_tpu_torch.models.gpen.face_enhancement as fe
    from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet

    fe.RRDBNet = functools.partial(RRDBNet, num_block=CHAIN["gpen"]["sr_num_block"])
    try:
        yield
    finally:
        fe.RRDBNet = RRDBNet


def config(name: str, chain: bool) -> dict:
    return {
        "name": name, "source": "tiny", "system": "e4s_swap", "net3": dict(NET3),
        "parser": {"name": "bisenet", "n_classes": 19, "parser_size": S},
        "stitch": "feather", "outer_dilation": 5, "chain": CHAIN if chain else None,
        "precision": {"dtype": "float32", "cuda.matmul.allow_tf32": False,
                      "cudnn.allow_tf32": False},
        "masked_conv": {"itemsize": 4, "regions": 12, "launches": [
            {"H": H, "Ci": Ci, "Co": Co, "up": up} for H, Ci, Co, up in LAUNCHES]},
        "flops_per_image": 1e9,
        "check": json.loads((BENCH / "configs" / ("e4s-reenact-1024.json" if chain else
                                                  "e4s-bisenet-1024.json")).read_text())["check"],
        "reduced": [], "assumed": []}


def mix(entry: str) -> dict:
    m = json.loads((BENCH / "traffic" / ("single.json" if entry == "swap"
                                          else "batch8.json")).read_text())
    m.update(pool=4 if entry == "swap" else 4, warmup=1, trace_calls=2, check_calls=2)
    if entry == "swap_batch":
        m.update(batch=2, chunk=2)
    return m


def make_tree(root: Path) -> Path:
    """The tiny tree under ``root``; returns its benchmark directory."""
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    for d in ("layers", "metrics", "systems", "entries"):
        os.symlink(BENCH / d, bench / d)
    os.symlink(BENCH / "traffic" / "faces", bench / "traffic" / "faces")
    for name, chain in (("tiny-swap", False), ("tiny-reenact", True)):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config(name, chain)))
    (bench / "traffic" / "tsingle.json").write_text(json.dumps(mix("swap")))
    (bench / "traffic" / "tbatch.json").write_text(json.dumps(mix("swap_batch")))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = [
        {"name": n, "source": "tiny", "file": f"benchmark/configs/{n}.json", "reduced": [],
         "why": "tiny"} for n in ("tiny-swap", "tiny-reenact")]
    cells = [("swap.single", "tiny-swap", "tsingle"), ("swap.batch", "tiny-swap", "tbatch"),
             ("reenact.single", "tiny-reenact", "tsingle"),
             ("reenact.batch", "tiny-reenact", "tbatch")]
    manifest["workloads"] = [{"name": c, "config": k, "traffic": t, "chips": 1, "why": "tiny"}
                             for c, k, t in cells]
    rename = {"swap1024.single": "swap.single", "reenact1024.single": "reenact.single",
              "swap1024.batch8": "swap.batch", "reenact1024.batch8": "reenact.batch"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench
