"""FaceVid2Vid's driving API in the PyTorch port against the JAX package at
shared weights: ``FaceVid2Vid.drive`` and ``reenact`` on inputs of other
sizes (the anti-aliased resize to 256^2, the pose, the generator),
``drive_source`` over a list of driving frames, and ``build_reenactor``.
The three nets are narrowed (the JAX ``drive`` runs at 256^2 only; the
generator's dense-motion network keeps its published width, at 64^2 x
depth 4). f32 on the CPU, relative to the reference's max |value|:
the resize and the posed keypoints of ``drive`` to 1e-4, the tolerance of
``tests/test_torch_reenact.py``, which holds the generator itself there at
fixed keypoints; the whole ``drive`` and
``drive_source`` to 2e-3, because at random weights the generator's
Gaussian keypoint heatmaps (variance 0.01) turn the keypoints' f32
rounding, ~1e-6, into ~5e-4 of the image (measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import aux_leaf, numpy_variables, rel_err, torch_threads
from tests.test_torch_reenact import KP_CFG

from e4s_tpu.models.facevid2vid import driver as jdriver
from e4s_tpu.models.facevid2vid.generator import OcclusionAwareSPADEGenerator as JGen
from e4s_tpu.models.facevid2vid.keypoint_detector import HEEstimator as JHE
from e4s_tpu.models.facevid2vid.keypoint_detector import KPDetector as JKP
from e4s_tpu.ops import resize as jresize

from e4s_tpu_torch import convert
from e4s_tpu_torch.models.facevid2vid.driver import FaceVid2Vid, build_reenactor, drive_source
from e4s_tpu_torch.models.facevid2vid.generator import OcclusionAwareSPADEGenerator
from e4s_tpu_torch.models.facevid2vid.keypoint_detector import HEEstimator, KPDetector
from e4s_tpu_torch.ops import resize
from e4s_tpu_torch.pipelines.model_io import materialise

TOL = 1e-4
TOL_DRIVE = 2e-3
HE_CFG = dict(block_expansion=16, max_features=256)
GEN_CFG = dict(feature_channel=4, block_expansion=64, max_features=16,
               num_down_blocks=2, reshape_channel=4, reshape_depth=4, num_resblocks=1)


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, 3, 256, 256))
    kp0 = {"value": jnp.zeros((1, 15, 3))}
    jkp, jhe, jgen = JKP(**KP_CFG), JHE(**HE_CFG), JGen(**GEN_CFG)
    v = {"kp_detector": numpy_variables(jax.eval_shape(lambda: jkp.init(key, x0)), 40, aux_leaf),
         "he_estimator": numpy_variables(jax.eval_shape(lambda: jhe.init(key, x0)), 41, aux_leaf),
         "generator": numpy_variables(
             jax.eval_shape(lambda: jgen.init(key, x0, kp0, kp0)), 42, aux_leaf)}
    jfv = jdriver.FaceVid2Vid(variables=v)
    jfv.kp_detector, jfv.he_estimator, jfv.generator = jkp, jhe, jgen
    port = FaceVid2Vid(
        materialise(lambda: KPDetector(**KP_CFG), convert.kp_detector_state_dict_from_jax(
            v["kp_detector"])),
        materialise(lambda: HEEstimator(**HE_CFG),
                    convert.he_estimator_state_dict_from_jax(v["he_estimator"])),
        materialise(lambda: OcclusionAwareSPADEGenerator(**GEN_CFG),
                    convert.fv_generator_state_dict_from_jax(v["generator"])))
    rng = np.random.RandomState(17)
    frames = [rng.rand(1, 3, *hw).astype(np.float32) for hw in ((96, 80), (64, 64), (80, 96))]
    return dict(jfv=jfv, port=port, frames=frames)


def test_drive_matches_jax(models):
    """Source 96 x 80 and driving 64^2, both resized to 256^2."""
    src, drv = models["frames"][:2]
    jfv, port = models["jfv"], models["port"]
    s, d = (jresize.antialiased_resize(jnp.asarray(a), (256, 256)) for a in (src, drv))
    v = jfv.variables
    kp_c = jfv._jit_kp(v["kp_detector"], s)
    kp_s, kp_d = (jdriver.keypoint_transformation(kp_c, jfv._jit_he(v["he_estimator"], a))
                  for a in (s, d))
    want = np.asarray(jfv.drive(src, drv))
    with torch_threads(4), torch.no_grad():
        ts, td = (resize.antialiased_resize(torch.from_numpy(a), (256, 256)) for a in (src, drv))
        got_kp_d, got_kp_s = port.pose(ts, td)
        got = port.drive(src, drv)
    assert rel_err(ts, s) < 1e-6 and rel_err(td, d) < 1e-6
    assert rel_err(got_kp_d["value"], kp_d["value"]) < TOL
    assert rel_err(got_kp_s["value"], kp_s["value"]) < TOL
    assert got.shape == (1, 3, 256, 256)
    assert rel_err(got, want) < TOL_DRIVE


def test_drive_source_matches_jax(models):
    src, *drivers = models["frames"]
    want = jdriver.drive_source(models["jfv"], src, drivers)
    with torch_threads(4):
        got = drive_source(models["port"], src, drivers)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):  # each the ``reenact`` callable's result
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        assert g.shape == (1, 3, 256, 256)
        assert rel_err(g, w) < TOL_DRIVE


def test_build_reenactor_gives_the_model_and_its_callable():
    with torch_threads(2):
        fv2v = build_reenactor(None, device="cpu", size=64, kp_kwargs=KP_CFG, gen_kwargs=dict(
            GEN_CFG, dense_motion_params=dict(block_expansion=8, num_blocks=2, max_features=32)))
        d01 = fv2v.reenact(np.full((1, 3, 48, 48), 0.5, np.float32),
                           np.full((1, 3, 40, 40), 0.25, np.float32))
    assert isinstance(fv2v, FaceVid2Vid)
    assert d01.shape == (1, 3, 64, 64) and np.isfinite(d01).all()
    assert torch.device("cpu") == next(fv2v.generator.parameters()).device
