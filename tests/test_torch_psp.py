"""pSp's legacy encoders in the PyTorch port against the JAX package's
``e4s_tpu/models/psp_legacy.py`` at shared weights, published widths
(IR-50 trunk), at 128^2 (the JAX tests' 256^2 halved): the four heads in IR
mode and one in IR-SE mode, to 1e-4 relative max (ROADMAP rule 3), f32 on
the CPU; each converter carries every JAX leaf to one pSp key, unchanged."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, rel_err, torch_threads

from e4s_tpu.models import psp_legacy as jpsp

from e4s_tpu_torch import convert
from e4s_tpu_torch.models import psp_legacy as tpsp
from e4s_tpu_torch.pipelines.model_io import materialise

TOL = 1e-4
S = 128
ENCODERS = {
    "gradual": ("GradualStyleEncoder", dict(n_styles=18), convert.psp_gradual_state_dict_from_jax),
    "w": ("BackboneEncoderUsingLastLayerIntoW", {}, convert.psp_w_state_dict_from_jax),
    "wplus": ("BackboneEncoderUsingLastLayerIntoWPlus", dict(n_styles=18),
              convert.psp_wplus_state_dict_from_jax),
    "custom": ("CustomBackboneEncoderUsingLastLayerIntoWPlus", {},
               convert.psp_wplus_state_dict_from_jax),
    "w_ir_se": ("BackboneEncoderUsingLastLayerIntoW", dict(mode="ir_se"),
                convert.psp_w_state_dict_from_jax),
}


@pytest.fixture(scope="module")
def case():
    """Numpy weights per encoder; the JAX outputs of all five in one jitted
    program."""
    x = np.random.RandomState(0).uniform(-1, 1, (1, 3, S, S)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jm = {k: getattr(jpsp, name)(**kw) for k, (name, kw, _) in ENCODERS.items()}
    v = {k: numpy_variables(jax.eval_shape(lambda m=m: m.init(key, jnp.zeros((1, 3, S, S)))),
                            50 + i) for i, (k, m) in enumerate(jm.items())}
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, x: {k: m.apply(v[k], x) for k, m in jm.items()})(v, x))
    return dict(x=x, v=v, want=want)


@pytest.mark.parametrize("enc", list(ENCODERS))
def test_encoder_matches_jax(case, enc):
    name, kw, conv = ENCODERS[enc]
    net = materialise(lambda: getattr(tpsp, name)(**kw), conv(case["v"][enc]))
    with torch_threads(2), torch.no_grad():
        got = net(torch.from_numpy(case["x"]))
    want = case["want"][enc]
    if enc == "custom":  # (codes, structure features)
        assert got[0].shape == (1, 11, 512) and got[1].shape == (1, 512, S // 8, S // 8)
        for g, w in zip(got, want):
            assert rel_err(g, w) < TOL
    else:
        assert got.shape == want.shape
        assert rel_err(got, want) < TOL


def _digest(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return hashlib.sha1(a.tobytes() + str(a.shape).encode()).hexdigest()


@pytest.mark.parametrize("enc", ["gradual", "custom", "w_ir_se"])
def test_converter_carries_every_leaf(case, enc):
    """Every JAX leaf lands, unchanged, under exactly one pSp key (a
    reshaped or renamed copy would not match), and every pSp key but
    BatchNorm's step counters comes from one leaf; the keys are pSp's."""
    name, kw, conv = ENCODERS[enc]
    sd = conv(case["v"][enc])
    with torch.device("meta"):
        keys = set(getattr(tpsp, name)(**kw).state_dict())
    assert set(sd) == keys
    leaves = [_digest(a) for a in jax.tree_util.tree_leaves(case["v"][enc])]
    carried = {k: _digest(t) for k, t in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(leaves) == sorted(carried.values())
    prefixes = {k.split(".")[0] for k in keys}
    assert prefixes <= {"input_layer", "body", "styles", "latlayer1", "latlayer2",
                        "output_layer_2", "linear", "structure_linear"}
