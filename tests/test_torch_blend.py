"""The port's Laplacian-pyramid blend (``e4s_tpu_torch/ops/blending.py``)
against the JAX package's ``e4s_tpu/ops/blending.py`` on seeded inputs, f32
on the CPU: 1e-4 relative max. The sizes reach the pyramid's 2x2 and 1x1
levels, where a pad of 2 is not smaller than the side and the padding
reflects more than once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import rel_err

from e4s_tpu.ops import blending as jb
from e4s_tpu_torch.ops import blending as tb

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (1, 3), (3, 2), (5, 5), (8, 12)])
def test_pyr_down_and_up_match_jax(hw):
    x = np.random.RandomState(hw[0] * 10 + hw[1]).rand(2, 3, *hw).astype(np.float32)
    for fn in ("pyr_down", "pyr_up"):
        want = np.asarray(getattr(jb, fn)(jnp.asarray(x)))
        got = getattr(tb, fn)(_t(x))
        assert got.shape == want.shape
        assert rel_err(got, want) < TOL


@pytest.mark.parametrize("size,levels", [(32, 6), (16, 5), (8, 4)])
def test_laplacian_blend_matches_jax_down_to_1x1(size, levels):
    rng = np.random.RandomState(size)
    a, b = (255 * rng.rand(2, 2, 3, size, size)).astype(np.float32)
    mask = rng.rand(2, 1, size, size).astype(np.float32)
    want = np.asarray(jax.jit(jb.laplacian_blend, static_argnums=3)(a, b, mask, levels))
    assert rel_err(tb.laplacian_blend(_t(a), _t(b), _t(mask), levels), want) < TOL


def test_blend_images_matches_jax_and_keeps_the_size():
    """Works at 1024^2 (10 levels) whatever the input size, resized back."""
    rng = np.random.RandomState(3)
    full, ori = (255 * rng.rand(2, 1, 3, 48, 48)).astype(np.float32)
    mask = np.repeat(rng.rand(1, 1, 48, 48) > 0.5, 3, axis=1).astype(np.float32)
    want = np.asarray(jax.jit(jb.blend_images)(full, ori, mask))
    got = tb.blend_images(_t(full), _t(ori), _t(mask))
    assert got.shape == (1, 3, 48, 48)
    assert rel_err(got, want) < TOL
