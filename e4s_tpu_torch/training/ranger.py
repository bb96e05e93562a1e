"""Ranger (gradient centralisation + RAdam + Lookahead) and the learning
rate schedule of training (counterpart of ``e4s_tpu/training/ranger.py``
and of the Coach's ``optax.piecewise_constant_schedule``).

``Ranger`` computes what the JAX package's optax chain computes: gradient
centralisation on tensors of rank > 1, RAdam (b1 0.95, b2 0.999, eps 1e-5,
SMA threshold 5), the learning rate, then Lookahead (every k = 6 steps the
fast weights are pulled half way to slow weights that start as a copy).
Its scalar coefficients are computed in float32, as the chain computes
them.
"""

from __future__ import annotations

import numpy as np
import torch

from e4s_tpu_torch.pipelines.optimization import CountedOptimizer

f32 = np.float32


def step_decay(lr: float, boundary: int = 100_000, factor: float = 0.1):
    """The schedule lr, times ``factor`` from update ``boundary`` on (a
    function of the count of earlier updates)."""
    return lambda count: lr * factor if count >= boundary else lr


class Ranger(CountedOptimizer):
    """``step()`` reads every parameter's ``.grad`` and updates the
    parameters in place."""

    def __init__(self, params, lr, alpha=0.5, k=6, b1=0.95, b2=0.999,
                 eps=1e-5, sma_threshold=5.0, use_gc=True):
        super().__init__(params, lr)
        self.alpha, self.k = alpha, k
        self.b1, self.b2, self.eps = b1, b2, eps
        self.sma_threshold, self.use_gc = sma_threshold, use_gc
        for p in self.param_groups[0]["params"]:
            self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                             "slow": p.detach().clone()}

    def _coefficients(self):
        """(rectified step scale, plain step scale, use the variance,
        1 - b2^t) at this count, in float32."""
        t = f32(self.count)
        b1, b2 = f32(self.b1), f32(self.b2)
        beta2_t = b2 ** t
        n_sma_max = f32(2.0 / (1 - self.b2) - 1.0)
        n_sma = n_sma_max - f32(2) * t * beta2_t / (f32(1) - beta2_t)
        ratio = ((n_sma - f32(4)) / max(n_sma_max - f32(4), f32(1e-8))
                 * (n_sma - f32(2)) / max(n_sma, f32(1e-8))
                 * n_sma_max / max(n_sma_max - f32(2), f32(1e-8)))
        bc1 = f32(1) - b1 ** t
        rect = np.sqrt(max(ratio, f32(0))) / bc1
        return float(rect), float(f32(1) / bc1), bool(n_sma > self.sma_threshold), \
            float(f32(1) - beta2_t)

    @torch.no_grad()
    def step(self):
        lr = self._next_lr()
        params, grads = self._params_and_grads()
        rect, plain, use_var, bc2 = self._coefficients()
        sync = self.count % self.k == 0
        for p, g in zip(params, grads):
            st = self.state[p]
            if self.use_gc and g.ndim > 1:
                g = g - g.mean(dim=tuple(range(1, g.ndim)), keepdim=True)
            st["mu"].copy_((1 - self.b1) * g + self.b1 * st["mu"])
            st["nu"].copy_(self.b2 * st["nu"] + (1 - self.b2) * g * g)
            if use_var:
                u = rect * st["mu"] / (torch.sqrt(st["nu"] / bc2) + self.eps)
            else:
                u = plain * st["mu"]
            fast = p + u * -lr
            if sync:
                st["slow"].add_(self.alpha * (fast - st["slow"]))
                fast = st["slow"]
            p.add_(fast - p)
