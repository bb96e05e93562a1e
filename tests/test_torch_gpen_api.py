"""GPEN's restoration API in the PyTorch port against the JAX package at
shared weights: ``GPENFullGeneratorSR``, the ``FaceGAN``, ``RealESRNet`` and
``FaceParse`` wrappers, ``FaceEnhancement.process`` (unaligned with
``force_one_face``, with fed-in detections of two faces and of a face under
100 px, aligned, and with ``in_size != out_size``), ``gpen_demo``,
``RetinaFaceDetector.detect`` at a square and a non-square size, the paste
mask's feather and cv2's uint8 resize.

Sizes are the JAX GPEN tests': GPEN at 64 with 1/8 of its channels, the SR
generator 32 -> 64, RealESRNet x4 with 2 blocks, ParseNet at 64 and
RetinaFace-R50 at 128. The JAX ``FaceEnhancement`` runs as it is, its cv2
host glue included; its RealESRNet and FaceParse take the small nets.

* Nets to 1e-4 relative max (ROADMAP rule 3); converters round-trip.
* ``process``: the uint8 result against the JAX glue's at >= 60 dB PSNR,
  the bar the JAX package holds its device chain to against the same glue
  (``tests/test_pipelines.py``); the crops and GPEN's faces, same count and
  shapes.
* ``detect``: the same kept detections in the same order, boxes and
  landmarks within 1e-4 of the image size.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import aux_leaf, numpy_variables, psnr_u8, rel_err, torch_threads
from tests.test_torch_reenact import KEYMAPS

from e4s_tpu.models.gpen import face_enhancement as jfe
from e4s_tpu.models.gpen.gpen_model import GPENFullGenerator as JGPEN
from e4s_tpu.models.gpen.gpen_model import GPENFullGeneratorSR as JGPENSR
from e4s_tpu.models.gpen.parsenet import ParseNet as JParseNet
from e4s_tpu.models.gpen.retinaface import RetinaFace as JRetinaFace
from e4s_tpu.models.gpen.rrdbnet import RRDBNet as JRRDBNet
from e4s_tpu.utils import torch_convert

from e4s_tpu_torch import convert
from e4s_tpu_torch.models.gpen import face_enhancement as tfe
from e4s_tpu_torch.models.gpen.gpen_model import GPENFullGenerator, GPENFullGeneratorSR
from e4s_tpu_torch.models.gpen.parsenet import ParseNet
from e4s_tpu_torch.models.gpen.retinaface import (
    RetinaFace,
    RetinaFaceDetector,
    detect_on_device,
)
from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
from e4s_tpu_torch.ops.resize import resize_u8
from e4s_tpu_torch.pipelines.model_io import materialise
from e4s_tpu_torch.pipelines.reenact_restore import DeviceRestore

TOL = 1e-4
PSNR = 60.0
IN = 64  # GPEN's side
SR_IN, SR_OUT = 32, 64  # the SR generator's
NARROW = 0.125
PS = 64  # ParseNet's side


@pytest.fixture(scope="module")
def nets():
    """Numpy weights in the JAX nets' shapes; the port's nets from the
    converters; the JAX ``FaceEnhancement`` (GPEN 64) and its in != out
    twin (GPEN-SR 32 -> 64), sharing the SR, the detector and the parser."""
    key = jax.random.PRNGKey(0)
    jm = {"fg": JGPEN(size=IN, narrow=NARROW),
          "fgsr": JGPENSR(in_size=SR_IN, out_size=SR_OUT, narrow=NARROW),
          "sr": JRRDBNet(scale=4, num_block=2), "pn": JParseNet(PS, PS),
          "rf": JRetinaFace()}
    shapes = {"fg": IN, "fgsr": SR_IN, "sr": 16, "pn": PS, "rf": 128}
    v = {k: numpy_variables(jax.eval_shape(lambda m=m, k=k: m.init(
        key, jnp.zeros((1, 3, shapes[k], shapes[k])))), 30 + i, aux_leaf)
        for i, (k, m) in enumerate(jm.items())}
    # RetinaFace's heads scaled down: scores near 0.5 (none above 0.9, so
    # force_one_face's stand-in is pasted) and boxes within exp's range
    for i in range(3):
        for head in ("ClassHead", "BboxHead", "LandmarkHead"):
            v["rf"]["params"][f"{head}_{i}"]["weight"] *= 0.01
    sds = {"fg": convert.gpen_state_dict_from_jax(v["fg"]),
           "fgsr": convert.gpen_sr_state_dict_from_jax(v["fgsr"]),
           "sr": convert.rrdbnet_state_dict_from_jax(v["sr"]),
           "pn": convert.parsenet_state_dict_from_jax(v["pn"]),
           "rf": convert.retinaface_state_dict_from_jax(v["rf"])}
    builds = {"fg": lambda: GPENFullGenerator(IN, narrow=NARROW),
              "fgsr": lambda: GPENFullGeneratorSR(SR_IN, SR_OUT, narrow=NARROW),
              "sr": lambda: RRDBNet(scale=4, num_block=2),
              "pn": lambda: ParseNet(PS, PS), "rf": RetinaFace}
    port = {k: materialise(b, sds[k]) for k, b in builds.items()}

    def jax_enh(fg, in_size, out_size=None):
        enh = jfe.FaceEnhancement(in_size=in_size, out_size=out_size, narrow=NARROW,
                                  variables={"facegan": v[fg], "srmodel": v["sr"],
                                             "parsenet": v["pn"], "retinaface": v["rf"]})
        enh.srmodel.model = jm["sr"]
        enh.faceparser.model, enh.faceparser.size = jm["pn"], PS
        enh.force_one_face = True  # refused beside given detector weights
        return enh

    jenh = jax_enh("fg", IN)
    jenh_sr = jax_enh("fgsr", SR_IN, SR_OUT)
    jenh_sr.srmodel, jenh_sr.faceparser, jenh_sr.facedetector = (
        jenh.srmodel, jenh.faceparser, jenh.facedetector)  # one compile each
    enh = tfe.FaceEnhancement(port["fg"], port["sr"], port["pn"], port["rf"],
                              in_size=IN, force_one_face=True)
    enh_sr = tfe.FaceEnhancement(port["fgsr"], port["sr"], port["pn"], port["rf"],
                                 in_size=SR_IN, out_size=SR_OUT, force_one_face=True)
    return dict(v=v, sds=sds, port=port, jm=jm, jenh=jenh, jenh_sr=jenh_sr,
                enh=enh, enh_sr=enh_sr)


def _img(h, w, seed):
    """A smooth BGR uint8 image (blocks of 4 pixels), as a face photo is."""
    rng = np.random.RandomState(seed)
    return np.kron(rng.randint(0, 256, (h // 4, w // 4, 3)),
                   np.ones((4, 4, 1))).astype(np.uint8)


def _same_faces(got, want):
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        assert [a.shape for a in g] == [a.shape for a in w]
        assert all(a.dtype == np.uint8 for a in g)


# ------------------------------- nets ---------------------------------------


def test_gpen_sr_matches_jax(nets):
    x = np.random.RandomState(1).uniform(-1, 1, (1, 3, SR_IN, SR_IN)).astype(np.float32)
    want = np.asarray(nets["jm"]["fgsr"].apply(nets["v"]["fgsr"], jnp.asarray(x))[0])
    with torch_threads(2), torch.no_grad():
        got = nets["port"]["fgsr"](torch.from_numpy(x))
    assert got.shape == (1, 3, SR_OUT, SR_OUT)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("wrapper", ["facegan", "srmodel", "faceparser"])
def test_wrappers_match_jax(nets, wrapper):
    """Each wrapper's net on its own input to 1e-4, and its ``process``
    (BGR uint8 in and out) against the JAX wrapper's."""
    jw = getattr(nets["jenh"], wrapper)
    net = getattr(nets["enh"], wrapper)
    port = {"facegan": lambda: tfe.FaceGAN(IN, net=net),
            "srmodel": lambda: tfe.RealESRNet(4, net=net),
            "faceparser": lambda: tfe.FaceParse(net=net)}[wrapper]()
    side = {"facegan": IN, "srmodel": 16, "faceparser": PS}[wrapper]
    x = np.random.RandomState(2).uniform(-1, 1, (1, 3, side, side)).astype(np.float32)
    want = np.asarray(jw._jit(jw.variables, jnp.asarray(x)))
    with torch_threads(2), torch.no_grad():
        got = port.model(torch.from_numpy(x))
    got = got[0] if isinstance(got, tuple) else got
    assert rel_err(got, want) < TOL
    img = _img(side, side, 3)
    with torch_threads(2):
        got_u8 = port.process(img)
    want_u8 = jw.process(img)
    assert got_u8.shape == want_u8.shape and got_u8.dtype == np.uint8
    assert psnr_u8(got_u8, want_u8) >= PSNR


def test_gpen_sr_converter_round_trips_and_keys(nets):
    """Through the JAX package's GPEN converter and back; the SR generator
    at 512 -> 1024 has every key of GPEN-BFR-512, at its shape."""
    got = torch_convert.convert_gpen_full_generator(nets["sds"]["fgsr"])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(nets["v"]["fgsr"]["params"])[0])
    assert flat_got.keys() == flat_want.keys()
    for k, a in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], a)
    with torch.device("meta"):
        sd = GPENFullGeneratorSR(512, 1024).state_dict()
    keymap = json.loads((KEYMAPS / "gpen_bfr_512.json").read_text())
    assert {k: list(sd[k].shape) for k in keymap} == keymap
    assert any(k.startswith("generator.convs.15.") for k in sd)  # the 1024 level


def test_build_restorer_builds_the_sr_generator_above_in_size():
    small = {"in_size": 16, "narrow": 0.125}
    assert type(tfe.build_restorer(small, "cpu").facegan) is GPENFullGenerator
    enh = tfe.build_restorer(small, "cpu", out_size=32)
    assert type(enh.facegan) is GPENFullGeneratorSR
    assert (enh.in_size, enh.out_size) == (16, 32)


# ------------------------------ process -------------------------------------


def test_process_unaligned_force_one_face(nets):
    """No detection above 0.9: the stand-in face (64 px at the SR's 128^2,
    so sharpened) is restored and pasted over the SR image."""
    img = _img(32, 32, 4)
    with torch_threads(2):
        got = nets["enh"].process(img)
    want = nets["jenh"].process(img.copy())
    assert got[0].shape == want[0].shape == (128, 128, 3)
    assert psnr_u8(got[0], want[0]) >= PSNR
    assert len(got[1]) == 1
    _same_faces(got, want)


def _fed(nets, monkeypatch, dets, lms):
    """Both packages see these detections (dets in NMS order)."""
    dets = np.asarray(dets, np.float32)
    lms = np.asarray(lms, np.float32)
    monkeypatch.setattr(nets["jenh"].facedetector, "detect", lambda img: (dets, lms))
    monkeypatch.setattr(DeviceRestore, "_det_stage", lambda self, up: (
        torch.from_numpy(dets[:, :4]), torch.from_numpy(lms), torch.from_numpy(dets[:, 4])))


def _lms(x0, y0, side):
    pts = np.array([[0.38, 0.62, 0.50, 0.40, 0.60], [0.42, 0.42, 0.55, 0.70, 0.70]])
    return np.concatenate([x0 + side * pts[0], y0 + side * pts[1]])


@pytest.mark.parametrize("case", ["two faces", "face under 100 px"])
def test_process_unaligned_fed_detections(nets, monkeypatch, case):
    """Two overlapping faces composited in NMS order (one of 104 px, one of
    64 px, sharpened), or one face under 100 px, on a 32 x 40 input."""
    faces = {"two faces": [([4, 6, 108, 110, 0.99], _lms(4, 6, 104)),
                           ([80, 50, 144, 114, 0.95], _lms(80, 50, 64))],
             "face under 100 px": [([50, 30, 130, 110, 0.97], _lms(50, 30, 80))]}[case]
    _fed(nets, monkeypatch, [f[0] for f in faces], [f[1] for f in faces])
    img = _img(32, 40, 5)
    with torch_threads(2):
        got = nets["enh"].process(img)
    want = nets["jenh"].process(img.copy())
    assert got[0].shape == want[0].shape == (128, 160, 3)
    assert len(got[1]) == len(faces)
    assert psnr_u8(got[0], want[0]) >= PSNR
    _same_faces(got, want)


def test_process_aligned(nets):
    """GPEN on the whole 48^2 crop resized to 64 (cv2's ratio 4/3 resize),
    then the x4 SR."""
    img = _img(48, 48, 6)
    with torch_threads(2):
        got = nets["enh"].process(img, aligned=True)
    want = nets["jenh"].process(img.copy(), aligned=True)
    assert got[0].shape == want[0].shape == (4 * IN, 4 * IN, 3)
    assert psnr_u8(got[0], want[0]) >= PSNR
    np.testing.assert_array_equal(got[1][0], img)
    assert psnr_u8(got[2][0], want[2][0]) >= PSNR
    _same_faces(got, want)


def test_process_with_in_size_below_out_size(nets):
    """GPEN-SR 32 -> 64: its 64^2 face is parsed at 64, the mask resized to
    32, the face (sharpened) resized to 32, and both warped back."""
    img = _img(32, 40, 7)
    with torch_threads(2):
        got = nets["enh_sr"].process(img)
    want = nets["jenh_sr"].process(img.copy())
    assert got[0].shape == want[0].shape == (128, 160, 3)
    assert got[2][0].shape == (SR_OUT, SR_OUT, 3) and got[1][0].shape == (SR_IN, SR_IN, 3)
    assert psnr_u8(got[0], want[0]) >= PSNR
    _same_faces(got, want)


def test_gpen_demo(nets):
    img = _img(32, 32, 8)
    with torch_threads(2):
        got = tfe.gpen_demo(img, nets["enh"])
        np.testing.assert_array_equal(got, nets["enh"].process(img)[0])
    assert psnr_u8(got, jfe.gpen_demo(img.copy(), nets["jenh"])) >= PSNR


# ------------------------------ detect --------------------------------------


@pytest.mark.parametrize("hw", [(128, 128), (128, 160)])
def test_detect_matches_jax(nets, hw):
    """The threshold sits in a gap of the scores, so that both packages keep
    the same candidates; top_k and keep_top_k cut."""
    img = _img(*hw, 9)
    det = RetinaFaceDetector(nets["port"]["rf"])
    with torch_threads(2), torch.no_grad():
        _, _, scores = detect_on_device(det.net, torch.from_numpy(img).float().permute(2, 0, 1)[None])
    s = np.sort(scores.numpy())[::-1]
    k = next(i for i in range(40, len(s) - 1) if s[i] - s[i + 1] > 1e-5)
    thr = float((s[k] + s[k + 1]) / 2)
    kw = dict(confidence_threshold=thr, nms_threshold=0.4, top_k=k - 5, keep_top_k=8)
    with torch_threads(2):
        dets, lms = det.detect(img, **kw)
    jdets, jlms = nets["jenh"].facedetector.detect(img, **kw)
    assert dets.shape == jdets.shape and len(dets) == 8
    np.testing.assert_allclose(dets[:, 4], jdets[:, 4], atol=1e-6)
    side = max(hw)
    assert np.abs(dets[:, :4] - jdets[:, :4]).max() <= 1e-4 * side
    assert np.abs(lms - jlms).max() <= 1e-4 * side


# --------------------------- the host steps ---------------------------------


def test_mask_postprocess_matches_jax(nets):
    m = (np.random.RandomState(10).rand(PS, PS) > 0.5).astype(np.float32)
    want = nets["jenh"].mask_postprocess(m.copy())
    got = tfe.FaceEnhancement.mask_postprocess(m.copy())
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)), ((32, 40), (128, 160)),
                                     ((48, 48), (64, 64)), ((100, 80), (37, 50))])
def test_resize_u8_is_cv2_resize(src, dst):
    img = np.random.RandomState(11).randint(0, 256, src + (3,)).astype(np.uint8)
    got = resize_u8(torch.from_numpy(img).permute(2, 0, 1), dst).permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1]))
