"""Entry ``swap_batch``: ``FaceSwapper.swap_batch(src_u8, tgt_u8, chunk)``,
``batch`` decoded uint8 pairs [batch,3,S,S] per call, uint8 arrays out.
The mix's pool is split into whole calls, cycled in order. (The interface
of an entry module: ``entries/swap.py``.)"""

from __future__ import annotations

import numpy as np

from benchmark.harness.traffic import make_pool

LAYERS = ("swap_batch_call",)


class Calls:
    def __init__(self, mix: dict, config: dict, seed: int, bench_dir, workdir, device="cpu"):
        self.mix, self.size = mix, config["net3"]["out_size"]
        self.per_call = B = mix["batch"]
        src, tgt = make_pool(mix, self.size, seed, bench_dir, device)
        if len(src) % B:
            raise ValueError("the pool must hold whole calls")
        self.calls = [(src[k:k + B], tgt[k:k + B]) for k in range(0, len(src), B)]
        self.n_calls = len(self.calls)

    def args(self, i: int):
        return self.calls[i % self.n_calls]

    def inputs(self, i: int):
        return self.args(i)


def call(system, args, mix: dict):
    return system.swap_batch(*args, chunk=mix["chunk"])


def result(calls: Calls, out) -> np.ndarray:
    S, n = calls.size, calls.per_call
    arr = np.asarray(out)
    if arr.dtype != np.uint8 or arr.shape != (n, 3, S, S):
        raise ValueError(f"result {arr.dtype} {arr.shape}, not uint8 ({n}, 3, {S}, {S})")
    return arr
