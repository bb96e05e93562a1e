"""The port's demo helper (``e4s_tpu_torch/demo``) and its mask-estimation
CLI (``e4s_tpu_torch/cli/estimate_ffhq_mask.py``):

* the headless cases of ``tests/test_demo.py``, on the port's copy;
* the two repairs of the JAX copy's ``paint_region`` and ``_sketch_strokes``
  (ROADMAP C3), each shown failing on the JAX copy's behaviour;
* ``DemoHelper`` at 256^2 (K=13, 14 styles, the encoder slim at 64^2; the
  parser at 512, as the JAX one) against the JAX ``DemoHelper`` at shared
  weights: the parsed masks on >= 99.9% of pixels, and ``texture_edit`` and
  ``generate`` at >= 40 dB uint8 PSNR (the bar of
  ``tests/test_torch_edit.py``);
* the CLI on a two-image tree against ``scripts/estimate_FFHQ_mask.py``:
  the same label files, agreeing on >= 99.9% of pixels (argmax near-ties of
  random weights), with ``--seg12`` and ``--save_vis``.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_helpers import numpy_variables, psnr_u8, torch_threads

import demo.gradio_demo as jdemo
from e4s_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s_tpu.models.bisenet import FaceParser as JFaceParser
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.pipelines import model_io as jmodel_io

from e4s_tpu_torch.cli import estimate_ffhq_mask as cli
from e4s_tpu_torch.convert import bisenet_state_dict_from_jax, net3_state_dict_from_jax
from e4s_tpu_torch.demo.gradio_demo import DemoHelper, paint_region, sketch_strokes
from e4s_tpu_torch.demo.gradio_utils import (
    COMP2INDEX,
    colored_mask_to_label_map,
    label_map_to_colored_mask,
)

S = 256
CFG = dict(out_size=S, remaining_layer_idx=13, n_styles=14)
ENC = dict(encoder_size=64, encoder_slim=True)  # the JAX package's test knobs


# ------------------------ the headless cases ---------------------------------


def test_colored_mask_round_trip():
    label_map = np.random.default_rng(0).integers(0, 12, size=(32, 32)).astype(np.uint8)
    colored = label_map_to_colored_mask(label_map)
    np.testing.assert_array_equal(colored_mask_to_label_map(colored), label_map)


def test_paint_region_repaints_strokes_only():
    label_map = np.zeros((16, 16), dtype=np.uint8)
    label_map[:8] = COMP2INDEX["skin"]
    strokes = np.zeros((16, 16, 4), dtype=np.uint8)  # RGBA, as gradio returns
    strokes[4:12, 4:12, :3] = 255
    edited, ok, msg = paint_region(label_map_to_colored_mask(label_map), strokes, "hair")
    assert ok and "hair" in msg
    out = colored_mask_to_label_map(edited)
    assert (out[4:12, 4:12] == COMP2INDEX["hair"]).all()
    np.testing.assert_array_equal(out[:4], label_map[:4])
    np.testing.assert_array_equal(out[12:], label_map[12:])


def test_paint_region_requires_region():
    base = np.zeros((8, 8, 3), dtype=np.uint8)
    edited, ok, msg = paint_region(base, np.zeros((8, 8, 4)), None)
    assert not ok and "choose the region" in msg
    np.testing.assert_array_equal(edited, base)


def _stub_helper():
    """A DemoHelper without its models: the callbacks' caching, lerps and
    messages."""
    h = DemoHelper.__new__(DemoHelper)
    h.src_img = np.zeros((8, 8, 3), dtype=np.uint8)
    h.initial_label_map = np.zeros((8, 8), dtype=np.uint8)
    h.initial_colored_map = label_map_to_colored_mask(h.initial_label_map)
    h.src_texture_vectors = np.ones((1, 12, 512), dtype=np.float32)
    h.ref_texture_vectors = np.full((1, 12, 512), 3.0, dtype=np.float32)
    h.generated_with = []
    h._generate = lambda label_map, tv: (
        h.generated_with.append((np.array(label_map), np.array(tv)))
        or np.zeros((8, 8, 3), dtype=np.uint8))
    return h


def test_texture_edit_lerps_only_chosen_regions():
    h = _stub_helper()
    _, msg = h.texture_edit(["hair", "eyes"], 0.5)
    assert "hair eyes" in msg
    label_map, tv = h.generated_with[-1]
    np.testing.assert_array_equal(label_map, h.initial_label_map)
    for name, idx in COMP2INDEX.items():
        np.testing.assert_allclose(tv[0, idx], 2.0 if name in ("hair", "eyes") else 1.0)


def test_texture_edit_empty_regions_is_a_noop_with_message():
    h = _stub_helper()
    img, msg = h.texture_edit([], 1.0)
    assert "choose the region" in msg and img is h.src_img
    assert h.generated_with == []


def test_shape_edit_uses_source_textures_and_edited_mask():
    h = _stub_helper()
    edited_map = np.full((8, 8), COMP2INDEX["hair"], dtype=np.uint8)
    _, msg = h.shape_edit(label_map_to_colored_mask(edited_map))
    assert "shape success" in msg
    label_map, tv = h.generated_with[-1]
    np.testing.assert_array_equal(label_map, edited_map)
    np.testing.assert_allclose(tv, h.src_texture_vectors)


def test_edit_mask_restarts_from_initial_map_like_the_reference():
    h = _stub_helper()
    strokes = np.zeros((8, 8, 4), dtype=np.uint8)
    strokes[0, 0, :3] = 255
    first, _ = h.edit_mask("hair", strokes)
    assert colored_mask_to_label_map(first)[0, 0] == COMP2INDEX["hair"]
    strokes2 = np.zeros((8, 8, 4), dtype=np.uint8)
    strokes2[1, 1, :3] = 255
    out = colored_mask_to_label_map(h.edit_mask("eyes", strokes2)[0])
    assert out[1, 1] == COMP2INDEX["eyes"] and out[0, 0] == 0


# --------------------------- the two repairs ----------------------------------


def test_a_2d_integer_stroke_array_repaints_only_its_strokes():
    """uint8 strokes [H,W] in {0,1}: the JAX copy indexes the label map with
    the integers, so it repaints rows 0 and 1 whole and misses the strokes."""
    base = label_map_to_colored_mask(np.zeros((16, 16), np.uint8))
    strokes = np.zeros((16, 16), np.uint8)
    strokes[5:9, 6:10] = 1
    want = np.zeros((16, 16), np.uint8)
    want[5:9, 6:10] = COMP2INDEX["hair"]
    edited, ok, _ = paint_region(base, strokes, "hair")
    assert ok
    np.testing.assert_array_equal(colored_mask_to_label_map(edited), want)
    jax_copy = colored_mask_to_label_map(jdemo.paint_region(base, strokes, "hair")[0])
    assert not np.array_equal(jax_copy, want)
    assert (jax_copy[:2] == COMP2INDEX["hair"]).all()


def test_a_gradio_4_sketch_value_gives_its_layers_strokes():
    """gradio >= 4 hands the sketch as {"background", "layers",
    "composite"}: the JAX copy's ``_sketch_strokes`` reads its absent
    ``mask`` as None and the repaint fails; the port takes the union of the
    layers' strokes (and no layer is no stroke)."""
    base = label_map_to_colored_mask(np.zeros((8, 8), np.uint8))
    layer = np.zeros((8, 8, 4), np.uint8)
    layer[2:4, 3:6] = (255, 255, 255, 255)
    value = {"background": np.zeros((8, 8, 4), np.uint8), "layers": [layer],
             "composite": layer}
    with pytest.raises(Exception):  # the JAX copy: np.asarray(value.get("mask"))
        jdemo.paint_region(base, np.asarray(value.get("mask")), "hair")
    edited, ok, _ = paint_region(base, sketch_strokes(value), "hair")
    assert ok
    want = np.zeros((8, 8), np.uint8)
    want[2:4, 3:6] = COMP2INDEX["hair"]
    np.testing.assert_array_equal(colored_mask_to_label_map(edited), want)
    assert sketch_strokes({"background": None, "layers": [], "composite": None}) is None
    edited, ok, msg = paint_region(base, None, "hair")
    assert not ok and "sketch" in msg
    np.testing.assert_array_equal(sketch_strokes({"image": base, "mask": layer}),
                                  sketch_strokes(layer))


# ------------------------- the helper on weights -------------------------------


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    jnet = JNet3(channels_last=True, **ENC, **CFG)
    v = numpy_variables(jax.eval_shape(lambda: jnet.init(
        {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)), jnp.zeros((1, 12, S, S)),
        latent_avg=jnp.zeros((14, 512)), randomize_noise=False)), seed=21)
    bv = numpy_variables(jax.eval_shape(
        lambda: JBiSeNet(n_classes=19).init(key, jnp.zeros((1, 3, 512, 512)))), seed=22)
    latent_avg = np.random.RandomState(23).randn(14, 512).astype(np.float32)
    d = tmp_path_factory.mktemp("ckpt")
    ckpts = dict(checkpoint_path=str(d / "net3.pt"), faceParsing_ckpt=str(d / "bisenet.pth"))
    torch.save({"state_dict": net3_state_dict_from_jax(v),
                "latent_avg": torch.from_numpy(latent_avg)}, ckpts["checkpoint_path"])
    torch.save(bisenet_state_dict_from_jax(bv), ckpts["faceParsing_ckpt"])
    # one JAX parser (one compile) for the demo and the mask script
    jparser = JFaceParser(variables=bv)
    jload = dict(load_net3=lambda opts: (jnet, v, jnp.asarray(latent_avg)),
                 load_face_parser=lambda opts, ckpt: jparser)
    return dict(ckpts=ckpts, jload=jload, jparser=jparser)


def _faces():
    rng = np.random.RandomState(24)
    return [np.kron(rng.randint(0, 256, (S // 16, S // 16, 3)),
                    np.ones((16, 16, 1))).astype(np.uint8) for _ in range(2)]


def test_demo_helper_matches_jax(weights, monkeypatch):
    """``texture_edit`` and ``generate`` (an edited mask with a texture
    lerp) against the JAX helper's; ``shape_edit`` is ``generate`` with no
    texture lerp, bit for bit (one JAX generation less: each is seconds of
    eager JAX here)."""
    src, ref = _faces()
    for name, fn in weights["jload"].items():
        monkeypatch.setattr(jmodel_io, name, fn)
    jh = jdemo.DemoHelper(types.SimpleNamespace(num_seg_cls=12, out_size=S,
                                                faceParsing_ckpt=None))
    opts = types.SimpleNamespace(num_seg_cls=12, start_from_latent_avg=True,
                                 **weights["ckpts"], **ENC, **CFG)
    with torch_threads(4):
        th = DemoHelper(opts, device="cpu")
        results = {}
        for h in (th, jh):
            h.set_source(src)
            h.set_reference(ref)
            edited = np.array(h.initial_colored_map)
            edited[S // 4:S // 2, S // 4:S // 2] = label_map_to_colored_mask(
                np.full((S // 4, S // 4), COMP2INDEX["hair"], np.uint8))
            results[h is th] = dict(
                mask=colored_mask_to_label_map(h.initial_colored_map),
                texture=h.texture_edit(["hair", "eyes"], 0.5)[0],
                generate=h.generate(edited, ["skin"], 0.7))
        shape = th.shape_edit(edited)[0]
        np.testing.assert_array_equal(shape, th.generate(edited))
    got, want = results[True], results[False]
    assert np.mean(got["mask"] == want["mask"]) >= 0.999
    assert len(np.unique(want["mask"])) >= 3  # the parse is not degenerate
    for k in ("texture", "generate"):
        assert got[k].shape == (S, S, 3) and got[k].dtype == np.uint8
        assert psnr_u8(got[k], want[k]) >= 40.0, k
    assert psnr_u8(got["texture"], shape) < 40.0  # the edits differ


def test_estimate_ffhq_mask_matches_the_jax_script(weights, tmp_path, monkeypatch):
    import scripts.estimate_FFHQ_mask as jscript
    from e4s_tpu_torch.pipelines.model_io import load_face_parser

    for root in ("jax", "port"):
        d = tmp_path / root / "images_1024" / "00000"
        d.mkdir(parents=True)
        for i, img in enumerate(_faces()):
            Image.fromarray(img).save(d / f"{i:05d}.png")
    monkeypatch.setattr(jmodel_io, "load_face_parser", weights["jload"]["load_face_parser"])
    monkeypatch.setattr(sys, "argv", ["estimate_FFHQ_mask.py", "--FFHQ_root",
                                      str(tmp_path / "jax"), "--seg12", "--save_vis",
                                      "--batch_size", "1"])
    jscript.main()
    opts = cli.options().parse_args(["--FFHQ_root", str(tmp_path / "port"), "--seg12",
                                     "--save_vis", "--batch_size", "2", "--device", "cpu",
                                     "--faceParsing_ckpt", weights["ckpts"]["faceParsing_ckpt"]])
    with torch_threads(4):
        cli.run(opts)
    for sub in ("BiSeNet_mask", "BiSeNet_mask_vis"):
        names = sorted(os.listdir(tmp_path / "jax" / sub / "00000"))
        assert names == sorted(os.listdir(tmp_path / "port" / sub / "00000")) == [
            "00000.png", "00001.png"]
    for name in names:
        got, want = (np.asarray(Image.open(tmp_path / r / "BiSeNet_mask" / "00000" / name))
                     for r in ("port", "jax"))
        assert got.shape == want.shape == (512, 512)
        assert np.mean(got == want) >= 0.999
        assert got.max() < 12  # --seg12
