"""Re-enactment in the PyTorch port against the JAX package at shared
weights: the warp and resize ops (grid sampling, the cv2 affine warp and
Gaussian blur, the skimage resize), the FaceVid2Vid keypoint detector,
head-pose estimator and SPADE generator at a 64^2 input (the generator with
one down block, so that its full-width 5-level dense-motion hourglass runs
at 32^2 x depth 4), the pose math, and the three converters (keys and
shapes of the reference checkpoint, the round trip through the JAX
package's converters). f32 on the CPU, modules to 1e-4 of the reference's
max |value|. The JAX nets are compiled as one program for the module."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import aux_leaf, numpy_variables, rel_err, torch_threads

from e4s_tpu.models.facevid2vid import driver as jdriver
from e4s_tpu.models.facevid2vid import util as jutil
from e4s_tpu.models.facevid2vid.generator import (
    OcclusionAwareSPADEGenerator as JGenerator,
)
from e4s_tpu.models.facevid2vid.keypoint_detector import (
    HEEstimator as JHE,
    KPDetector as JKP,
)
from e4s_tpu.ops import resize as jresize
from e4s_tpu.ops import warp as jwarp
from e4s_tpu.utils import torch_convert

from e4s_tpu_torch import convert
from e4s_tpu_torch.models.facevid2vid import driver, util
from e4s_tpu_torch.models.facevid2vid.generator import OcclusionAwareSPADEGenerator
from e4s_tpu_torch.models.facevid2vid.keypoint_detector import HEEstimator, KPDetector
from e4s_tpu_torch.ops import resize, warp
from e4s_tpu_torch.pipelines.model_io import materialise

TOL = 1e-4
KEYMAPS = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_keymaps"
KP_CFG = dict(block_expansion=8, max_features=64, reshape_channel=128,
              reshape_depth=4, num_blocks=2)
GEN_CFG = dict(feature_channel=4, block_expansion=128, max_features=16,
               num_down_blocks=1, reshape_channel=4, reshape_depth=4,
               num_resblocks=2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def nets():
    """Numpy weights in the JAX nets' shapes, the JAX outputs at a 64^2
    input (one jitted program), and the port's nets from the converters."""
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((2, 3, 64, 64))
    kp0 = {"value": jnp.zeros((2, 15, 3))}
    jkp, jhe, jgen = JKP(**KP_CFG), JHE(), JGenerator(**GEN_CFG)
    v = {
        "kp": numpy_variables(jax.eval_shape(lambda: jkp.init(key, x0)), 0, aux_leaf),
        "he": numpy_variables(jax.eval_shape(lambda: jhe.init(key, x0)), 1, aux_leaf),
        "gen": numpy_variables(
            jax.eval_shape(lambda: jgen.init(key, x0, kp0, kp0)), 2, aux_leaf),
    }
    rng = np.random.RandomState(3)
    x = rng.rand(2, 3, 64, 64).astype(np.float32)
    kp_d = rng.uniform(-0.6, 0.6, (2, 15, 3)).astype(np.float32)
    kp_s = (kp_d + rng.uniform(-0.1, 0.1, (2, 15, 3))).astype(np.float32)

    @jax.jit
    def run(v, x, kp_d, kp_s):
        gen = jgen.apply(v["gen"], x, {"value": kp_d}, {"value": kp_s})
        return (jkp.apply(v["kp"], x)["value"], jhe.apply(v["he"], x),
                gen["prediction"], gen["occlusion_map"], gen["mask"])

    want = jax.tree_util.tree_map(np.asarray, run(v, x, kp_d, kp_s))
    sds = {
        "kp": convert.kp_detector_state_dict_from_jax(v["kp"]),
        "he": convert.he_estimator_state_dict_from_jax(v["he"]),
        "gen": convert.fv_generator_state_dict_from_jax(v["gen"]),
    }
    port = {
        "kp": materialise(lambda: KPDetector(**KP_CFG), sds["kp"]),
        "he": materialise(HEEstimator, sds["he"]),
        "gen": materialise(lambda: OcclusionAwareSPADEGenerator(**GEN_CFG), sds["gen"]),
    }
    return dict(v=v, sds=sds, port=port, want=want, x=x, kp_d=kp_d, kp_s=kp_s)


def test_kp_detector_matches_jax(nets):
    with torch_threads(2):
        got = nets["port"]["kp"](_t(nets["x"]))["value"]
    assert rel_err(got, nets["want"][0]) < TOL


@pytest.mark.parametrize("head", ["yaw", "pitch", "roll", "t", "exp"])
def test_he_estimator_matches_jax(nets, head):
    with torch_threads(2):
        got = nets["port"]["he"](_t(nets["x"]))
    assert rel_err(got[head], nets["want"][1][head]) < TOL


@pytest.mark.parametrize("output", ["prediction", "occlusion_map", "mask"])
def test_generator_matches_jax(nets, output):
    """The whole generator: encoder, 3-D res blocks, dense motion (sparse
    motions, the 3-D warp, the hourglass, mask softmax and occlusion), the
    deformation of the features and the SPADE decoder."""
    if "gen_out" not in nets:
        with torch_threads(4):
            nets["gen_out"] = nets["port"]["gen"](
                _t(nets["x"]), {"value": _t(nets["kp_d"])},
                {"value": _t(nets["kp_s"])})
    idx = {"prediction": 2, "occlusion_map": 3, "mask": 4}[output]
    assert rel_err(nets["gen_out"][output], nets["want"][idx]) < TOL


def _op_inputs():
    rng = np.random.RandomState(4)
    he = {k: rng.randn(2, n).astype(np.float32)
          for k, n in (("yaw", 66), ("pitch", 66), ("roll", 66), ("t", 3), ("exp", 45))}
    return dict(
        kp=rng.uniform(-1, 1, (2, 15, 3)).astype(np.float32), he=he,
        angles=rng.uniform(-90, 90, 3).astype(np.float32),
        kp_small=rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32),
        vol=rng.randn(2, 3, 4, 5, 6).astype(np.float32),
        g3=rng.uniform(-1.3, 1.3, (2, 3, 4, 5, 3)).astype(np.float32),
        u8img=(rng.rand(3, 40, 50) * 255).astype(np.float32),
        m=np.array([[0.8, 0.3, -5.0], [-0.25, 1.1, 7.5]], np.float32),
        blur0=rng.rand(64, 80).astype(np.float32),
        blur1=rng.rand(2, 60, 52).astype(np.float32),
        res=rng.rand(1, 3, 96, 80).astype(np.float32))


@pytest.fixture(scope="module")
def ops():
    """The inputs of the op tests and the JAX package's outputs for them,
    from one jitted program."""
    x = _op_inputs()

    @jax.jit
    def run(x):
        a = x["angles"]
        return {
            "kp": jdriver.keypoint_transformation({"value": x["kp"]}, x["he"])["value"],
            "rot": jdriver.get_rotation_matrix(a, a * 0.5, -a),
            "gauss": jutil.kp2gaussian(x["kp_small"], (4, 6, 8), 0.01),
            "grid": jutil.make_coordinate_grid_3d(3, 4, 5),
            **{f"gs3_{ac}": jwarp.grid_sample_3d(x["vol"], x["g3"], ac) for ac in (False, True)},
            "affine": jwarp.affine_warp(x["u8img"], x["m"], (45, 35)),
            "blur0": jwarp.gaussian_blur_cv2(x["blur0"], 101, 11.0),
            "blur1": jwarp.gaussian_blur_cv2(x["blur1"], 101, 11.0),
            "res_256": jresize.antialiased_resize(x["res"], (256, 256)),
            "res_16": jresize.antialiased_resize(x["res"], (16, 24)),
        }

    return x, jax.tree_util.tree_map(np.asarray, run(x))


def test_keypoint_transformation_matches_jax(ops):
    x, want = ops
    got = driver.keypoint_transformation({"value": _t(x["kp"])},
                                         {k: _t(a) for k, a in x["he"].items()})
    assert rel_err(got["value"], want["kp"]) < TOL
    a = _t(x["angles"])
    assert rel_err(driver.get_rotation_matrix(a, a * 0.5, -a), want["rot"]) < TOL


def test_kp2gaussian_and_grid_match_jax(ops):
    x, want = ops
    assert rel_err(util.kp2gaussian(_t(x["kp_small"]), (4, 6, 8), 0.01), want["gauss"]) < TOL
    np.testing.assert_array_equal(util.make_coordinate_grid_3d(3, 4, 5).numpy(), want["grid"])


# ----------------------------------- ops -----------------------------------


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(ops, align_corners):
    """3-D (the fv2v warp), with coordinates outside [-1, 1] (zero
    padding)."""
    x, want = ops
    assert rel_err(warp.grid_sample_3d(_t(x["vol"]), _t(x["g3"]), align_corners),
                   want[f"gs3_{align_corners}"]) < TOL


def test_affine_warp_matches_jax(ops):
    x, want = ops
    assert rel_err(warp.affine_warp(_t(x["u8img"]), x["m"], (45, 35)), want["affine"]) < TOL


@pytest.mark.parametrize("which", ["blur0", "blur1"])
def test_gaussian_blur_matches_jax(ops, which):
    """GPEN's feather blur (101 taps, sigma 11), the radius of 50 next to
    sides of 52-80: REFLECT_101 borders."""
    x, want = ops
    assert rel_err(warp.gaussian_blur_cv2(_t(x[which]), 101, 11.0), want[which]) < TOL


def test_gaussian_blur_reflects_past_the_side():
    """A radius larger than the side folds the border again, as jnp.pad's
    reflect does (a plain F.pad reflect would refuse it)."""
    x = np.random.RandomState(9).rand(20, 24).astype(np.float32)
    want = np.pad(x, 50, mode="reflect")
    r = np.arange(-50, 51, dtype=np.float32)
    k = np.exp(-0.5 * (r / 11.0) ** 2)
    k /= k.sum()
    want = np.apply_along_axis(lambda a: np.convolve(a, k, "valid"), 0, want)
    want = np.apply_along_axis(lambda a: np.convolve(a, k, "valid"), 1, want)
    assert rel_err(warp.gaussian_blur_cv2(_t(x), 101, 11.0), want) < TOL


@pytest.mark.parametrize("size", [(256, 256), (16, 24)])
def test_antialiased_resize_matches_jax(ops, size):
    x, want = ops
    assert rel_err(resize.antialiased_resize(_t(x["res"]), size),
                   want[f"res_{size[0]}"]) < TOL


# ------------------------------ converters ---------------------------------


@pytest.mark.parametrize("name,build", [
    ("facevid2vid_kp_detector", KPDetector),
    ("facevid2vid_he_estimator", HEEstimator),
    ("facevid2vid_generator", OcclusionAwareSPADEGenerator),
])
def test_full_width_keys_match_keymap(name, build):
    """The vox-256 nets have the reference checkpoint's keys and shapes, so
    ``00000189-checkpoint.pth.tar`` loads with ``load_state_dict``."""
    with torch.device("meta"):
        sd = build().state_dict()
    want = json.loads((KEYMAPS / f"{name}.json").read_text())
    assert {k: list(v.shape) for k, v in sd.items()} == want


@pytest.mark.parametrize("net,jax_convert", [
    ("kp", torch_convert.convert_kp_detector),
    ("he", torch_convert.convert_he_estimator),
    ("gen", torch_convert.convert_fv_generator),
])
def test_converter_round_trip(nets, net, jax_convert):
    """JAX -> the port's state_dict -> the JAX package's own converter gives
    the JAX variables back (spectral norm refolded to the same weights)."""
    params, stats = jax_convert(nets["sds"][net])
    got = {"params": params, "batch_stats": stats}
    want = nets["v"][net]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        {k: want[k] for k in ("params", "batch_stats") if k in want})[0])
    assert flat_got.keys() == flat_want.keys()
    for k, a in flat_want.items():
        np.testing.assert_allclose(flat_got[k], a, rtol=1e-6, atol=1e-7)
