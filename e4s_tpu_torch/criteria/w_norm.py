"""W-norm loss (counterpart of ``e4s_tpu/criteria/w_norm.py``)."""

from __future__ import annotations

import torch


def w_norm_loss(latent, latent_avg=None, start_from_latent_avg: bool = True):
    """Mean over samples and regions of the Frobenius norm of each
    [n_latent, 512] code, less ``latent_avg`` when ``start_from_latent_avg``.
    latent: [B, R, n_latent, 512]; latent_avg: [n_latent, 512].

    ``vector_norm``, as the reference's ``Tensor.norm``, gives a zero norm
    a zero gradient; the JAX package's sqrt of the sum gives NaN there. A
    zero code is what a region absent from the mask gets from LocalMLPs
    whose biases are still 0 (a model from random weights)."""
    if start_from_latent_avg:
        latent = latent - latent_avg[None, None]
    norms = torch.linalg.vector_norm(latent, dim=(2, 3))
    return norms.sum() / (latent.shape[0] * latent.shape[1])
