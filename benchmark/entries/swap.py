"""Entry ``swap``: ``FaceSwapper.swap(source_path, target_path)``, one pair
per call, image files in and a PIL image out. The mix's pairs are written
as JPEG files of quality ``jpeg_quality`` in the run's work directory at
set-up and cycled in order, so every call pays the decode.

An entry module gives the harness ``Calls(mix, config, seed, bench_dir,
workdir, device)`` (``mix``, ``n_calls``, ``per_call``, ``args(i)``,
``inputs(i)``, ``size``), ``call(system, args, mix)``, ``result(calls, out)`` (the result
as uint8 [n,3,S,S], raising if it is malformed) and the ``LAYERS`` its
traced runs wrap.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.harness.traffic import make_pool, to_chw_u8

LAYERS = ("swap_call",)


class Calls:
    """``args(i)``: the file paths of call i (cycled); ``inputs(i)``: the
    uint8 [1,3,S,S] source and target it hands the system, read back from
    the JPEG files as the system decodes them."""

    per_call = 1

    def __init__(self, mix: dict, config: dict, seed: int, bench_dir, workdir, device="cpu"):
        from PIL import Image

        self.mix, self.size = mix, config["net3"]["out_size"]
        src, tgt = make_pool(mix, self.size, seed, bench_dir, device)
        os.makedirs(workdir, exist_ok=True)
        self.paths = []
        for k in range(len(src)):
            pair = []
            for tag, img in (("s", src[k]), ("t", tgt[k])):
                path = os.path.join(workdir, f"pair{k:03d}_{tag}.jpg")
                Image.fromarray(img.transpose(1, 2, 0)).save(path, quality=mix["jpeg_quality"])
                pair.append(path)
            self.paths.append(tuple(pair))
        self.n_calls = len(self.paths)

    def args(self, i: int):
        return self.paths[i % self.n_calls]

    def inputs(self, i: int):
        from PIL import Image

        S = self.size
        return tuple(to_chw_u8(Image.open(p).convert("RGB").resize((S, S)))[None]
                     for p in self.args(i))


def call(system, args, mix: dict):
    return system.swap(*args)


def result(calls: Calls, out) -> np.ndarray:
    S = calls.size
    arr = np.asarray(out)
    if arr.dtype != np.uint8 or arr.shape != (S, S, 3):
        raise ValueError(f"result {arr.dtype} {arr.shape}, not uint8 ({S}, {S}, 3)")
    return arr.transpose(2, 0, 1)[None]
