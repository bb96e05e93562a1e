"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are drawn with numpy from a seed in the shapes that
``jax.eval_shape(module.init, ...)`` reports (never through ``init``, whose
compile dominates at full width); the same arrays go to the JAX module as
they are and to the port through ``e4s_tpu_torch.convert``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def psnr_u8(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _leaf(rng, path, shape):
    """A value for one leaf, by its name, at a scale that keeps f32
    activations in range through the full-depth networks."""
    name = path[-1]
    size = int(np.prod(shape)) if shape else 1
    n = rng.standard_normal(size, dtype=np.float32).reshape(shape)
    if name == "running_var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name in ("running_mean",) or (name == "bias" and "modulation" not in path):
        return 0.1 * n
    if name == "bias":  # modulation: styles around 1
        return 1.0 + 0.1 * n
    if "prelu" in "/".join(path):
        return 0.25 + 0.05 * n
    if "bn" in path[-2] or path[-2].endswith("_norm1") or "bn_atten" in path:
        return 1.0 + 0.1 * n
    if name == "weight" and path[-2] == "noise":
        return 0.1 * n
    if name.startswith("layer_scale_"):  # SegNeXt block residual scales
        return 0.1 * n
    # SegNeXt norms: block BatchNorms, GroupNorms, stage LayerNorms
    if (name == "weight" and (path[-2] in ("norm1", "norm2")
                              or path[-2].endswith("_norm"))):
        return 1.0 + 0.1 * n
    if name.startswith("norm") and name.endswith(("_weight", "_bias")):
        return (1.0 if name.endswith("_weight") else 0.0) + 0.1 * n
    in_g = "G" in path or path[0].startswith(("style_", "conv1", "convs_", "to_rgb"))
    if name == "weight" and len(shape) == 4 and not in_g:
        return n / np.sqrt(np.prod(shape[1:]))  # plain conv: fan-in scale
    return n


def aux_leaf(rng, path, shape):
    """A value for one leaf of the re-enactment and restoration nets
    (FaceVid2Vid, GPEN, RealESRNet, RetinaFace, ParseNet): plain convs and
    linears at a fan-in scale (2-D and 3-D alike), frozen BatchNorms near
    identity, GPEN's equalised layers at unit scale (they scale themselves)
    with modulation biases around 1."""
    name = path[-1]
    size = int(np.prod(shape)) if shape else 1
    n = rng.standard_normal(size, dtype=np.float32).reshape(shape)
    equalised = path[0] in ("generator", "final_linear") or path[0].startswith("ecd")
    if name == "running_var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "running_mean":
        return 0.1 * n
    if name == "bias" and "modulation" in path:
        return 1.0 + 0.1 * n
    if name in ("bias", "noise_weight") or name.endswith("_bias"):
        return 0.1 * n
    if name == "weight" and len(path) > 1 and ("norm" in path[-2] or "bn" in path[-2]):
        return 1.0 + 0.1 * n
    if equalised:
        return n
    if len(shape) >= 2:  # conv / linear weights: fan-in
        return n / np.sqrt(np.prod(shape[1:]))
    return n


def numpy_variables(shape_tree, seed: int, leaf=_leaf):
    """Nested dict of ShapeDtypeStructs -> same tree of seeded numpy arrays
    (each leaf's value from ``leaf(rng, path, shape)``)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return np.asarray(leaf(rng, path, tuple(node.shape)), np.float32)

    return walk(shape_tree, ())


@contextlib.contextmanager
def torch_threads(n: int):
    """Cap torch's intra-op threads (the suite runs several workers)."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
