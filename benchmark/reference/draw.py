"""Weights drawn from a seed in a few large calls on the device.

``Draw`` hands out consecutive slices of two streams, standard normal and
uniform in [-1, 1), each refilled a chunk at a time from one
``torch.Generator`` on the device. The same seed on the same device gives
the same weights; ``init_module_`` (``models/layers.py``) walks a model
with it in module order.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 26  # values per draw (256 MiB of float32)


class Draw:
    def __init__(self, seed: int, device, chunk: int = CHUNK):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.chunk = chunk
        self._buf = {"normal": None, "uniform": None}
        self._pos = {"normal": 0, "uniform": 0}

    def _take(self, kind: str, n: int):
        buf, pos = self._buf[kind], self._pos[kind]
        if buf is None or pos + n > buf.numel():
            size = max(self.chunk, n)
            buf = torch.empty(size, device=self.device)
            if kind == "normal":
                buf.normal_(generator=self.gen)
            else:
                buf.uniform_(-1.0, 1.0, generator=self.gen)
            self._buf[kind], pos = buf, 0
        self._pos[kind] = pos + n
        return buf[pos:pos + n]

    def normal(self, shape):
        shape = tuple(shape)
        return self._take("normal", _numel(shape)).reshape(shape)

    def uniform(self, shape, bound: float):
        """Uniform in [-bound, bound)."""
        shape = tuple(shape)
        return self._take("uniform", _numel(shape)).reshape(shape) * bound


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
