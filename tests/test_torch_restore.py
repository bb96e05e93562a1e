"""Restoration and the re-enact -> restore chain in the PyTorch port,
against the JAX package at shared weights, at the JAX GPEN tests' sizes:
GPEN ``size=64`` (its channels narrowed to 1/8), RealESRNet x4 with 2
blocks on 32^2, ParseNet at 64 and RetinaFace-R50 at 128.

* The four nets to 1e-4 relative max; their keys and shapes against the
  reference checkpoints' keymaps; the converters' round trips.
* The chain's four stages against the JAX ``DeviceReenactRestore``'s own
  stage methods (an instance made with ``object.__new__`` holding the small
  nets; its ``__init__`` takes only 512): the pose at 256 (the JAX stage's
  size) from a 64^2 uint8 pair, the SR stage, the detection's decode, and
  the restore stage for one face, all in one jitted JAX program.
* The three cases the JAX chain hands to its cv2 host glue, which the port
  does on the device, checked against that glue's arithmetic: the
  small-face ``cv2.filter2D`` sharpen, the composite of several faces in
  NMS order (``face_enhancement.py:219-226`` in numpy), no face (the SR
  image), and a candidate list longer than the JAX chain's 16.
* ``FaceSwapper`` with the port's re-enactor and restorer (fused, staged
  with a target mask, ``swap_batch`` on uint8 and float) and the CLI.
"""

import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_helpers import aux_leaf, numpy_variables, psnr_u8, rel_err, torch_threads
from tests.test_torch_reenact import KP_CFG, KEYMAPS

from e4s_tpu.models.facevid2vid.keypoint_detector import HEEstimator as JHE
from e4s_tpu.models.facevid2vid.keypoint_detector import KPDetector as JKP
from e4s_tpu.models.gpen.gpen_model import GPENFullGenerator as JGPEN
from e4s_tpu.models.gpen.parsenet import ParseNet as JParseNet
from e4s_tpu.models.gpen.retinaface import RetinaFace as JRetinaFace
from e4s_tpu.models.gpen.rrdbnet import RRDBNet as JRRDBNet
from e4s_tpu.pipelines.reenact_restore import DeviceReenactRestore as JChain
from e4s_tpu.utils import torch_convert

from e4s_tpu_torch import convert
from e4s_tpu_torch.cli import face_swap as cli
from e4s_tpu_torch.models.facevid2vid.driver import FaceVid2Vid, build_reenactor
from e4s_tpu_torch.models.facevid2vid.keypoint_detector import HEEstimator, KPDetector
from e4s_tpu_torch.models.gpen.align_faces import (
    get_reference_facial_points,
    invert_affine,
    similarity_pair,
)
from e4s_tpu_torch.models.gpen.face_enhancement import FaceEnhancement, build_restorer
from e4s_tpu_torch.models.gpen.gpen_model import GPENFullGenerator
from e4s_tpu_torch.models.gpen.parsenet import ParseNet
from e4s_tpu_torch.models.gpen.retinaface import RetinaFace
from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
from e4s_tpu_torch.pipelines import reenact_restore
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper
from e4s_tpu_torch.pipelines.model_io import materialise
from e4s_tpu_torch.pipelines.reenact_restore import DeviceReenactRestore

TOL = 1e-4
IN = 64  # GPEN's and ParseNet's side
NARROW_FG = 0.125  # GPEN's channels: 64 for 512
PRED = 32  # the re-enacted image's side; the SR's output is 4x
S = 4 * PRED
# uint8 images of the stages, port against JAX: the same f32 arithmetic in
# another order moves a value across a rounding or truncation boundary in a
# few pixels by one level; 60 dB is the JAX package's own bar for its chain
# against its host glue (tests/test_pipelines.py)
PSNR_STAGE = 60.0
# the restore stage's output: at random weights a ParseNet argmax flips on a
# near tie where the two logits differ by f32 rounding, and the flipped
# pixel moves the feathered mask over a 101-tap blur; 45 dB bounds that
PSNR_RESTORE = 45.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _one_face_lms(S, frac=0.5):
    """``force_one_face``'s canonical landmarks for a centred box of side
    ``frac * S`` as [10] (x's then y's)."""
    pts = np.array([[0.38, 0.62, 0.50, 0.40, 0.60], [0.42, 0.42, 0.55, 0.70, 0.70]])
    lo = (1 - frac) / 2
    return np.stack([S * (lo + frac * pts[0]), S * (lo + frac * pts[1])]).reshape(10)


@pytest.fixture(scope="module")
def case():
    key = jax.random.PRNGKey(0)
    jm = {"kp": JKP(**KP_CFG), "he": JHE(), "sr": JRRDBNet(scale=4, num_block=2),
          "rf": JRetinaFace(), "fg": JGPEN(size=IN, narrow=NARROW_FG), "pn": JParseNet(IN, IN)}
    shapes_in = {"kp": (1, 3, 256, 256), "he": (1, 3, 256, 256), "sr": (1, 3, PRED, PRED),
                 "rf": (1, 3, S, S), "fg": (1, 3, IN, IN), "pn": (1, 3, IN, IN)}
    v = {k: numpy_variables(jax.eval_shape(
        lambda m=m, k=k: m.init(key, jnp.zeros(shapes_in[k]))), i, aux_leaf)
        for i, (k, m) in enumerate(jm.items())}
    # RetinaFace's heads scaled down: distinct scores (none saturated at 1,
    # so the top 16 are one set) and boxes within exp's range
    for i in range(3):
        for head in ("ClassHead", "BboxHead", "LandmarkHead"):
            v["rf"]["params"][f"{head}_{i}"]["weight"] *= 0.01

    # the stages' own net calls are tapped: each net's input and output
    # there are what the net tests below take (no second copy of a net in
    # the JAX program)
    taps = {}

    class Tap:
        def __init__(self, name):
            self.name = name

        def apply(self, variables, x):
            taps[self.name] = (x, jm[self.name].apply(variables, x))
            return taps[self.name][1]

    jc = object.__new__(JChain)
    jc.fv2v = types.SimpleNamespace(kp_detector=jm["kp"], he_estimator=jm["he"])
    jc.enh = types.SimpleNamespace(
        srmodel=types.SimpleNamespace(model=Tap("sr")),
        facedetector=types.SimpleNamespace(net=Tap("rf")),
        facegan=types.SimpleNamespace(model=Tap("fg")),
        faceparser=types.SimpleNamespace(model=Tap("pn")), in_size=IN)
    jc._act = jnp.float32

    rng = np.random.RandomState(11)
    s_u8 = rng.randint(0, 256, (1, 3, 64, 64)).astype(np.uint8)
    t_u8 = rng.randint(0, 256, (1, 3, 64, 64)).astype(np.uint8)
    pred = rng.rand(1, 3, PRED, PRED).astype(np.float32)
    ref5 = get_reference_facial_points((IN, IN), 0.25, (0, 0), True)
    tfm, tfm_inv = similarity_pair(_one_face_lms(S).reshape(2, 5), ref5)
    minv = (invert_affine(tfm), invert_affine(tfm_inv))

    @jax.jit
    def run(v, s_u8, t_u8, pred, minv_crop, minv_back):
        s256, kp_d, kp_s = jc._prep_pose(v["kp"], v["he"], s_u8, t_u8)
        sr, up = jc._sr_stage(v["sr"], pred)
        det = jc._det_stage(v["rf"], up)
        out = jc._restore_stage(v["fg"], v["pn"], up, sr, minv_crop, minv_back)
        return (s256, kp_d["value"], kp_s["value"], sr, up, det, out), dict(taps)

    stages, nets = jax.tree_util.tree_map(
        np.asarray, run(v, s_u8, t_u8, pred, *minv))

    sds = {"kp": convert.kp_detector_state_dict_from_jax(v["kp"]),
           "he": convert.he_estimator_state_dict_from_jax(v["he"]),
           "sr": convert.rrdbnet_state_dict_from_jax(v["sr"]),
           "rf": convert.retinaface_state_dict_from_jax(v["rf"]),
           "fg": convert.gpen_state_dict_from_jax(v["fg"]),
           "pn": convert.parsenet_state_dict_from_jax(v["pn"])}
    builds = {"kp": lambda: KPDetector(**KP_CFG), "he": HEEstimator,
              "sr": lambda: RRDBNet(scale=4, num_block=2), "rf": RetinaFace,
              "fg": lambda: GPENFullGenerator(IN, narrow=NARROW_FG),
              "pn": lambda: ParseNet(IN, IN)}
    port = {k: materialise(b, sds[k]) for k, b in builds.items()}
    fv2v = FaceVid2Vid(port["kp"], port["he"], None, size=256)
    enh = FaceEnhancement(port["fg"], port["sr"], port["pn"], port["rf"], in_size=IN)
    chain = DeviceReenactRestore(fv2v, enh)
    return dict(v=v, sds=sds, port=port, chain=chain, stages=stages, nets=nets,
                s_u8=s_u8, t_u8=t_u8, pred=pred, minv=minv)


# --------------------------------- nets ------------------------------------


@pytest.mark.parametrize("net", ["sr", "fg", "pn_mask", "pn_img", "rf_loc", "rf_conf",
                                 "rf_landms"])
def test_net_matches_jax(case, net):
    """Each net on the input the JAX chain's stage gave it."""
    name, _, part = net.partition("_")
    x, want = case["nets"][name]
    with torch_threads(2), torch.no_grad():
        got = case["port"][name](_t(x))
    if name == "fg":  # the JAX generator returns (image, latents or None)
        want = want[0]
    if part:
        k = {"mask": 0, "img": 1, "loc": 0, "conf": 1, "landms": 2}[part]
        got, want = got[k], want[k]
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("name,build", [
    ("gpen_bfr_512", GPENFullGenerator),
    ("gpen_realesrnet", lambda: RRDBNet(scale=2)),  # the keymap's file is x2
    ("gpen_retinaface_r50", RetinaFace),
    ("gpen_parsenet", ParseNet),
])
def test_full_width_keys_match_keymap(name, build):
    import json

    with torch.device("meta"):
        sd = build().state_dict()
    want = json.loads((KEYMAPS / f"{name}.json").read_text())
    assert {k: list(v.shape) for k, v in sd.items()} == want


@pytest.mark.parametrize("net,jax_convert", [
    ("sr", torch_convert.convert_rrdbnet),
    ("rf", torch_convert.convert_retinaface),
    ("fg", torch_convert.convert_gpen_full_generator),
    ("pn", torch_convert.convert_parsenet),
])
def test_converter_round_trip(case, net, jax_convert):
    res = jax_convert(case["sds"][net])
    got = ({"params": res[0], "batch_stats": res[1]} if isinstance(res, tuple)
           else {"params": res})
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        {k: case["v"][net][k] for k in got})[0])
    assert flat_got.keys() == flat_want.keys()
    for k, a in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], a)


@pytest.mark.parametrize("fn", ["prior_boxes", "decode_boxes", "decode_landms",
                                "py_cpu_nms", "umeyama", "reference_points"])
def test_numpy_helpers_match_jax(fn):
    """The port's own copies of the JAX package's numpy helpers (the
    decodes on tensors: the chain's detect stage runs them)."""
    from e4s_tpu.models.gpen import align_faces as jalign
    from e4s_tpu.models.gpen import retinaface as jrf
    from e4s_tpu_torch.models.gpen import align_faces as talign
    from e4s_tpu_torch.models.gpen import retinaface as trf

    rng = np.random.RandomState(16)
    priors = jrf.prior_boxes((96, 64))
    loc, pre = rng.randn(len(priors), 4), rng.randn(len(priors), 10)
    dets = np.concatenate([rng.rand(30, 2) * 50, rng.rand(30, 2) * 50 + 30,
                           rng.rand(30, 1)], 1).astype(np.float32)
    src = rng.rand(5, 2) * 100
    got, want = {
        "prior_boxes": lambda: (trf.prior_boxes((96, 64)), priors),
        "decode_boxes": lambda: (trf.decode_boxes(_t(loc), _t(priors)),
                                 jrf.decode_boxes(loc, priors)),
        "decode_landms": lambda: (trf.decode_landms(_t(pre), _t(priors)),
                                  jrf.decode_landms(pre, priors)),
        "py_cpu_nms": lambda: (trf.py_cpu_nms(dets, 0.4), jrf.py_cpu_nms(dets, 0.4)),
        "umeyama": lambda: (talign.umeyama(src, src[::-1] * 1.3)[0],
                            jalign.umeyama(src, src[::-1] * 1.3)[0]),
        "reference_points": lambda: (
            talign.get_reference_facial_points((512, 512), 0.25, (0, 0), True),
            jalign.get_reference_facial_points((512, 512), 0.25, (0, 0), True)),
    }[fn]()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------- the chain's stages ------------------------------


def test_prep_pose_matches_jax(case):
    with torch_threads(2):
        s, kp_d, kp_s = case["chain"]._prep_pose(_t(case["s_u8"]), _t(case["t_u8"]))
    want = case["stages"]
    assert rel_err(s, want[0]) < TOL
    assert rel_err(kp_d["value"], want[1]) < TOL
    assert rel_err(kp_s["value"], want[2]) < TOL


def test_sr_stage_matches_jax(case):
    with torch_threads(2), torch.no_grad():
        sr, up = case["chain"]._sr_stage(_t(case["pred"]))
    assert sr.dtype == up.dtype == torch.uint8
    assert psnr_u8(sr, case["stages"][3]) >= PSNR_STAGE
    assert psnr_u8(up, case["stages"][4]) >= PSNR_STAGE


def test_det_stage_matches_jax(case):
    """The decode of every prior; the JAX stage keeps its top 16."""
    with torch_threads(2), torch.no_grad():
        boxes, lms, scores = case["chain"]._det_stage(_t(case["stages"][4]))
    jb, jl, js = case["stages"][5]
    top, idx = torch.topk(scores, 16)
    assert rel_err(top, js) < TOL
    assert rel_err(boxes[idx], jb) < TOL
    assert rel_err(lms[idx], jl) < TOL


def test_restore_stage_matches_jax(case):
    st = case["stages"]
    with torch_threads(2), torch.no_grad():
        out = case["chain"]._restore_stage(_t(st[4]), _t(st[3]),
                                           [(*case["minv"], False)])
    assert out.dtype == torch.uint8 and out.shape == (1, 3, S, S)
    assert psnr_u8(out, st[6]) >= PSNR_RESTORE


# -------------- the cases the JAX chain leaves to its host glue --------------


@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 37, 50)])
def test_small_face_sharpen_is_cv2_filter2d(shape):
    img = np.random.RandomState(12).randint(0, 256, shape).astype(np.uint8)
    k = np.array([[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
                  [0.0625, 0.125, 0.0625]], np.float32)
    want = cv2.filter2D(np.ascontiguousarray(img.transpose(1, 2, 0)), -1, k)
    got = reenact_restore.filter2d_sharpen_u8(_t(img)).numpy().transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)


def _patched_detections(chain, monkeypatch, dets, lms):
    """Make ``_det_stage`` return these candidates (and nothing else)."""
    boxes = torch.tensor(np.asarray(dets, np.float32)[:, :4])
    scores = torch.tensor(np.asarray(dets, np.float32)[:, 4])
    monkeypatch.setattr(chain, "_det_stage", lambda up: (boxes, _t(np.float32(lms)), scores))


def test_two_faces_composite_in_nms_order(case, monkeypatch):
    """Two overlapping faces: each restored face replaces the pixels where
    its mask exceeds the mask of the faces before it (``full_mask``), in
    NMS order, then base * (1 - mask) + faces * mask, truncated."""
    chain = case["chain"]
    lms = np.stack([_one_face_lms(S, 0.6), _one_face_lms(S, 0.5) + 6.0])
    dets = [[20, 20, 110, 110, 0.95], [50, 50, 100, 100, 0.99]]  # IoU 0.31
    _patched_detections(chain, monkeypatch, dets, lms)
    with torch_threads(2), torch.no_grad():
        got = chain.restore(_t(case["pred"]))
        faces = chain.last_faces
        sr, up = chain._sr_stage(_t(case["pred"]))
        parts = [chain._restore_face(up, mc, mb, small, S) for mc, mb, small in faces]
    assert len(faces) == 2 and all(f[2] for f in faces)  # both under 100 px
    # NMS order is by score: the second detection first
    tfm, tfm_inv = similarity_pair(lms[1].reshape(2, 5), chain.enh.reference_5pts)
    np.testing.assert_allclose(faces[0][0], invert_affine(tfm))
    full_mask = np.zeros((S, S), np.float32)
    full_img = np.zeros((S, S, 3), np.uint8)
    for m, img in parts:
        tmp_mask = m.numpy()
        tmp_img = img.numpy().transpose(1, 2, 0).astype(np.uint8)
        mask = tmp_mask - full_mask
        full_mask[np.where(mask > 0)] = tmp_mask[np.where(mask > 0)]
        full_img[np.where(mask > 0)] = tmp_img[np.where(mask > 0)]
    base = sr[0].numpy().transpose(1, 2, 0)
    fm = full_mask[:, :, None]
    want = np.clip(base * (1 - fm) + full_img * fm, 0, 255).astype(np.uint8)
    assert psnr_u8(got[0].numpy().transpose(1, 2, 0), want) >= PSNR_STAGE


def test_small_face_is_sharpened_before_the_paste(case, monkeypatch):
    """A face under 100 px: the restored face goes through cv2.filter2D's
    sharpen before it is warped back (the mask is the unsharpened face's)."""
    chain = case["chain"]
    _patched_detections(chain, monkeypatch, [[40, 40, 100, 100, 0.99]],
                        _one_face_lms(S, 0.5)[None])
    seen = []
    real = reenact_restore.filter2d_sharpen_u8

    def spy(img):
        seen.append((img.clone(), real(img)))
        return seen[-1][1]

    monkeypatch.setattr(reenact_restore, "filter2d_sharpen_u8", spy)
    with torch_threads(2), torch.no_grad():
        chain.restore(_t(case["pred"]))
    assert len(seen) == 1 and seen[0][0].shape == (3, IN, IN)
    k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16
    src = np.ascontiguousarray(seen[0][0].numpy().transpose(1, 2, 0))
    np.testing.assert_array_equal(seen[0][1].numpy().transpose(1, 2, 0),
                                  cv2.filter2D(src, -1, k))


def test_no_face_returns_the_sr_image(case, monkeypatch):
    chain = case["chain"]
    _patched_detections(chain, monkeypatch, [[40, 40, 100, 100, 0.5]],
                        _one_face_lms(S)[None])
    with torch_threads(2), torch.no_grad():
        got = chain.restore(_t(case["pred"]))
        sr, _ = chain._sr_stage(_t(case["pred"]))
    assert chain.last_faces == []
    assert torch.equal(got, sr)


def test_more_candidates_than_the_jax_top_k(case):
    """20 separate faces at or above the threshold (the JAX chain keeps 16
    and hands a full list to its host glue): every one is downloaded and
    survives NMS, in descending score order."""
    n = 20
    boxes = torch.tensor([[10.0 * i, 0, 10.0 * i + 8, 8] for i in range(n)])
    scores = torch.linspace(0.91, 0.99, n)
    lms = torch.tensor(np.stack([_one_face_lms(8) + np.array([10.0 * i] * 5 + [0] * 5)
                                 for i in range(n)]), dtype=torch.float32)
    faces = case["chain"]._faces(boxes, lms, scores, 256)
    assert len(faces) == n
    tfm, _ = similarity_pair(lms[-1].numpy().reshape(2, 5),
                             case["chain"].enh.reference_5pts)
    np.testing.assert_allclose(faces[0][0], invert_affine(tfm))


def test_force_one_face_is_refused_with_detector_weights(tmp_path):
    """With ``RetinaFace-R50.pth`` in place the stand-in face would be pasted
    over real detections' absence: refused before anything is built."""
    (tmp_path / "weights").mkdir()
    torch.save({}, tmp_path / "weights" / "RetinaFace-R50.pth")
    with pytest.raises(ValueError, match="force_one_face"):
        build_restorer({"base_dir": str(tmp_path), "force_one_face": True}, "cpu")


# ------------------------ FaceSwapper and the CLI ---------------------------

SW = 64  # out_size of the small swap: fv2v at 16^2, SR x4 -> 64^2
SMALL_FV2V = dict(
    size=16, kp_kwargs=KP_CFG,
    gen_kwargs=dict(feature_channel=4, block_expansion=64, max_features=16,
                    num_down_blocks=2, reshape_channel=4, reshape_depth=4,
                    num_resblocks=1, dense_motion_params=dict(
                        block_expansion=8, num_blocks=2, max_features=32)))
SMALL_GPEN = {"in_size": 32, "narrow": 0.125, "force_one_face": True}


def _small_models(device):
    """The port's re-enactor and restorer at the small sizes above, the
    restorer's RealESRNet cut to one block."""
    enh = build_restorer(SMALL_GPEN, device=device, seed=4)
    enh.srmodel = materialise(lambda: RRDBNet(scale=4, num_block=1), None, 5, device)
    return build_reenactor(None, device=device, seed=3, **SMALL_FV2V), enh


# Net3 narrowed (the JAX package's test knobs: a one-unit-per-stage
# encoder, generator channels / 8): the swap after the chain is the port's
# own, checked against JAX elsewhere
NARROW = dict(encoder_size=SW, parser_size=SW, encoder_slim=True, ch_div=8)


def _swap_opts(**kw):
    return types.SimpleNamespace(
        num_seg_cls=12, start_from_latent_avg=True, out_size=SW,
        remaining_layer_idx=7, n_styles=10, checkpoint_path=None,
        faceParsing_ckpt=None, **NARROW, **kw)


@pytest.fixture(scope="module")
def swapper():
    with torch_threads(2):
        re, rs = _small_models("cpu")
        return FaceSwapper(_swap_opts(), device="cpu", reenactor=re, restorer=rs)


def _pairs(n):
    rng = np.random.RandomState(13)
    u8 = lambda: np.kron(rng.randint(0, 256, (n, 3, 8, 8)),
                         np.ones((8, 8))).astype(np.uint8)
    return u8(), u8()


def test_swap_runs_the_chain_then_the_fused_swap(swapper):
    s_u8, t_u8 = _pairs(1)
    with torch_threads(2):
        got = swapper.swap_from_arrays(s_u8 / 255.0, t_u8 / 255.0)
        d = swapper.chain(_t(s_u8), _t(t_u8))
        want = swapper._swap_e2e(d, _t(t_u8), swapper.latent_avg)[0]
    assert d.shape == (1, 3, SW, SW) and swapper.chain.last_faces
    np.testing.assert_array_equal(np.asarray(got), want[0].permute(1, 2, 0).numpy())


def test_staged_swap_takes_the_restored_source(swapper):
    s_u8, t_u8 = _pairs(1)
    mask = np.kron(np.random.RandomState(14).randint(0, 12, (8, 8)), np.ones((8, 8), int))
    with torch_threads(2):
        got = swapper.swap_from_arrays(s_u8 / 255.0, t_u8 / 255.0, target_mask=mask)
        d = swapper.chain(_t(s_u8), _t(t_u8)).float() / 255.0
        want = swapper._swap_staged(d, t_u8 / 255.0, mask, None)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_swap_batch_uint8_and_float_agree(swapper):
    """uint8 pairs go to the chain as uint8 and float pairs as their rounded
    uint8: the same result (the port never reads [0,255] as [0,1]); each
    equals the chain pair by pair, then one fused chunk, padded."""
    s_u8, t_u8 = _pairs(3)
    with torch_threads(2):
        got_u8 = swapper.swap_batch(s_u8, t_u8, chunk=2)
        got_f = swapper.swap_batch(s_u8 / 255.0, t_u8 / 255.0, chunk=2)
        d = torch.cat([swapper.chain(_t(s_u8[i:i + 1]), _t(t_u8[i:i + 1]))
                       for i in (2, 2)])
        want = swapper._swap_e2e(d, _t(t_u8[[2, 2]]), swapper.latent_avg)[0]
    assert got_u8.dtype == np.uint8 and got_u8.shape == (3, 3, SW, SW)
    np.testing.assert_array_equal(got_u8, np.round(got_f * 255).astype(np.uint8))
    np.testing.assert_array_equal(got_u8[2], want[0].numpy())


def test_swap_batch_with_target_masks_takes_the_restored_sources(swapper):
    s_u8, t_u8 = _pairs(2)
    masks = np.kron(np.random.RandomState(15).randint(0, 12, (2, 8, 8)),
                    np.ones((8, 8), int))
    with torch_threads(2):
        got = swapper.swap_batch(s_u8 / 255.0, t_u8 / 255.0, target_masks=masks)
        d = torch.cat([swapper.chain(_t(s_u8[i:i + 1]), _t(t_u8[i:i + 1]))
                       for i in range(2)]).float() / 255.0
        want = swapper._swap_batch_staged(d, (t_u8 / 255.0).astype(np.float32), masks)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="float"):
        swapper.swap_batch(s_u8, t_u8, target_masks=masks)


def test_swapper_takes_the_reenactor_and_restorer_together():
    with pytest.raises(ValueError, match="together"):
        FaceSwapper(_swap_opts(), device="cpu", reenactor=lambda s, t: s)


def test_cli_reenacts_with_the_models_and_falls_back_without(swapper, tmp_path,
                                                             monkeypatch, capsys):
    s_u8, t_u8 = _pairs(1)
    paths = []
    for name, img in (("src", s_u8[0]), ("tgt", t_u8[0])):
        paths.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(img.transpose(1, 2, 0)).save(paths[-1])
    args = ["--source", paths[0], "--target", paths[1], "--device", "cpu",
            "--out_size", str(SW), "--remaining_layer_idx", "7", "--n_styles", "10",
            "--checkpoint_path", "", "--faceParsing_ckpt", ""]

    def opts(out):
        o = cli.SwapFacePipelineOptions().parse(args + ["--output_dir", str(tmp_path / out)])
        vars(o).update(NARROW)
        return o

    built = {}

    def make_both(o, device):
        built["device"] = device
        return _small_models(device)

    monkeypatch.setattr(cli, "try_build_reenactor_restorer", make_both)
    with torch_threads(2):
        cli.run(opts("re"))
        want = swapper.swap_from_arrays(s_u8 / 255.0, t_u8 / 255.0)
    assert built["device"] == "cpu"
    got = np.asarray(Image.open(tmp_path / "re" / "swap_src_to_tgt.png"))
    np.testing.assert_array_equal(got, np.asarray(want))

    monkeypatch.undo()
    with torch_threads(2):
        cli.run(opts("plain"))
    assert "falling back to direct source texture" in capsys.readouterr().out
    assert (tmp_path / "plain" / "swap_src_to_tgt.png").exists()


@pytest.mark.slow
def test_full_size_chain_matches_jax():
    """The port's chain at the published sizes (FaceVid2Vid vox-256,
    RealESRNet x4 with 23 blocks, RetinaFace-R50 at 1024^2, GPEN-BFR-512,
    ParseNet 512) against the JAX ``DeviceReenactRestore`` on the inputs of
    ``tests/test_pipelines.py::test_device_chain_matches_host_glue``, at
    shared numpy weights. RetinaFace's class head is zeroed (every score
    0.5), so both chains paste ``force_one_face``'s stand-in face. D to
    >= 60 dB, the JAX test's bar for its chain against its host glue.
    Minutes on the CPU."""
    from e4s_tpu.models.facevid2vid.driver import FaceVid2Vid as JFaceVid2Vid
    from e4s_tpu.models.facevid2vid.generator import OcclusionAwareSPADEGenerator as JGen
    from e4s_tpu.models.gpen.face_enhancement import FaceEnhancement as JEnh
    from e4s_tpu_torch.models.facevid2vid.generator import OcclusionAwareSPADEGenerator

    key = jax.random.PRNGKey(0)
    x256, kp0 = jnp.zeros((1, 3, 256, 256)), {"value": jnp.zeros((1, 15, 3))}
    shapes = {
        "kp_detector": jax.eval_shape(lambda: JKP().init(key, x256)),
        "he_estimator": jax.eval_shape(lambda: JHE().init(key, x256)),
        "generator": jax.eval_shape(lambda: JGen().init(key, x256, kp0, kp0)),
        "srmodel": jax.eval_shape(lambda: JRRDBNet(scale=4).init(key, jnp.zeros((1, 3, 64, 64)))),
        "retinaface": jax.eval_shape(lambda: JRetinaFace().init(key, jnp.zeros((1, 3, 512, 512)))),
        "facegan": jax.eval_shape(lambda: JGPEN(size=512).init(key, jnp.zeros((1, 3, 512, 512)))),
        "parsenet": jax.eval_shape(lambda: JParseNet(512, 512, 32, 64, 19, min_ch=32, max_ch=256)
                                   .init(key, jnp.zeros((1, 3, 512, 512)))),
    }
    v = {k: numpy_variables(s, 20 + i, aux_leaf) for i, (k, s) in enumerate(shapes.items())}
    for i in range(3):
        for leaf in ("weight", "bias"):
            v["retinaface"]["params"][f"ClassHead_{i}"][leaf] *= 0.0

    fv2v_vars = {k: v[k] for k in ("kp_detector", "he_estimator", "generator")}
    jfv = JFaceVid2Vid(variables=fv2v_vars)
    jenh = JEnh(variables={k: v[k] for k in ("srmodel", "retinaface", "facegan", "parsenet")})
    jenh.force_one_face = True  # its constructor refuses it beside given detector weights
    jchain = JChain(jfv, jenh, out_size=1024)

    rng = np.random.RandomState(0)
    S01 = (rng.randint(0, 256, (1, 3, 1024, 1024)) / 255.0).astype(np.float32)
    T01 = (rng.randint(0, 256, (1, 3, 1024, 1024)) / 255.0).astype(np.float32)
    s_u8 = np.clip(S01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    t_u8 = np.clip(T01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    want = np.asarray(jchain(jnp.asarray(s_u8), jnp.asarray(t_u8)))

    build = {"kp_detector": (KPDetector, convert.kp_detector_state_dict_from_jax),
             "he_estimator": (HEEstimator, convert.he_estimator_state_dict_from_jax),
             "generator": (OcclusionAwareSPADEGenerator,
                           convert.fv_generator_state_dict_from_jax),
             "srmodel": (RRDBNet, convert.rrdbnet_state_dict_from_jax),
             "retinaface": (RetinaFace, convert.retinaface_state_dict_from_jax),
             "facegan": (GPENFullGenerator, convert.gpen_state_dict_from_jax),
             "parsenet": (ParseNet, convert.parsenet_state_dict_from_jax)}
    port = {k: materialise(cls, conv(v[k])) for k, (cls, conv) in build.items()}
    chain = DeviceReenactRestore(
        FaceVid2Vid(port["kp_detector"], port["he_estimator"], port["generator"]),
        FaceEnhancement(port["facegan"], port["srmodel"], port["parsenet"],
                        port["retinaface"], force_one_face=True))
    with torch_threads(8):
        got = chain(_t(s_u8), _t(t_u8)).numpy()
    p = psnr_u8(got, want)
    print(f"full-size chain, port vs JAX: D uint8 PSNR {p:.2f} dB")
    assert len(chain.last_faces) == 1 and p >= 60.0
