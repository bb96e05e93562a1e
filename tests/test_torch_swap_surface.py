"""The port's swap surface beyond the fused BiSeNet path, against the JAX
package at shared weights: the SegNeXt parser with the Laplacian blend in
``make_swap_e2e``, ``FaceSwapper.swap_batch`` (uint8 and float, a padded
last chunk), the staged path with a caller's target mask, the crop path
with fixed landmarks and the CLI on the CPU.

One JAX program is the reference for all of them: ``make_swap_e2e`` with
``taxonomy="celeba19"`` and ``lap_bld=True`` at batch 2, out_size 64, K=7,
10 styles, a reduced SegNeXt (depth 1 per stage) parsing at 64^2. A pair
that stands alone is run as a batch of two copies of itself, which is what
the padded last chunk of ``swap_batch`` computes: the texture swap's ear and
mouth fallbacks are decided over a batch. That lone pair is the JAX
package's crop of two image files at fixed landmarks, so the crop path, the
staged path, the CLI and the padded chunk share one JAX run. Labels must
agree on >= 99.9% of pixels and uint8 images to >= 40 dB PSNR.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_helpers import numpy_variables, psnr_u8, rel_err, torch_threads

import e4s_tpu.models.segnext as jseg
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.pipelines.swap_core import make_swap_e2e as j_make_swap_e2e
from e4s_tpu.pipelines.swap_core import reconstruct_core as j_reconstruct_core
from e4s_tpu.utils.alignment import crop_and_align_face as j_crop_and_align

import e4s_tpu_torch.models.segnext as tseg
from e4s_tpu_torch.cli import face_swap as cli
from e4s_tpu_torch.convert import net3_state_dict_from_jax, segnext_state_dict_from_jax
from e4s_tpu_torch.pipelines import swap_core
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper
from e4s_tpu_torch.pipelines.model_io import materialise
from e4s_tpu_torch.utils import alignment

CFG = dict(out_size=64, remaining_layer_idx=7, n_styles=10, encoder_size=64)
S = 64
REDUCED = dict(embed_dims=(16, 32, 32, 64), depths=(1, 1, 1, 1),
               mlp_ratios=(2, 2, 2, 2), head_in=(32, 32, 64), ham_channels=256)


def _opts(ckpts, **kw):
    return types.SimpleNamespace(
        num_seg_cls=12, start_from_latent_avg=True, parser_size=S,
        faceParser_name="segnext", lap_bld=True, **ckpts, **CFG, **kw)


def _blocks(rng, n):
    """n seeded uint8 images of 8x8-pixel colour blocks."""
    return np.kron(rng.randint(0, 256, (n, 3, 8, 8)), np.ones((8, 8))).astype(np.uint8)


def _face_landmarks(cx, cy, scale):
    """A fixed 68-point layout (eyes at 36-47, mouth corners at 48 and 54)
    centred at (cx, cy)."""
    rng = np.random.RandomState(int(cx))
    lm = np.stack([cx + scale * rng.uniform(-1, 1, 68),
                   cy + scale * rng.uniform(-1, 1, 68)], axis=1)
    lm[36:42] = [cx - 0.4 * scale, cy - 0.3 * scale]
    lm[42:48] = [cx + 0.4 * scale, cy - 0.3 * scale]
    lm[48] = [cx - 0.3 * scale, cy + 0.5 * scale]
    lm[54] = [cx + 0.3 * scale, cy + 0.5 * scale]
    return lm


def _crop_pair(d):
    """Two image files of 8x8-pixel colour blocks and fixed landmarks; the
    JAX package's crops (as [1,3,S,S] uint8 each) with its
    crop_and_align_face result."""
    rng = np.random.RandomState(9)
    files = []
    for name in ("src", "tgt"):
        arr = np.kron(rng.randint(0, 256, (10, 12, 3)), np.ones((8, 8, 1)))
        path = d / f"{name}.png"
        Image.fromarray(arr.astype(np.uint8)).save(path)
        files.append((name, str(path)))
    landmarks = [_face_landmarks(48, 40, 14), _face_landmarks(44, 38, 12)]
    ref = j_crop_and_align(files, image_size=S, landmarks=landmarks)
    crops = [np.transpose(np.asarray(c.convert("RGB")), (2, 0, 1))[None]
             for c in ref[0]]
    return files, landmarks, ref, crops


def _calibrate_classifier(sv, images):
    """Shift SegNeXt's classifier bias so each class has the same mean logit
    over ``images``: with random weights one class wins everywhere
    otherwise, and the parse would be a single region."""
    model = materialise(lambda: tseg.SegNeXt("reduced"),
                        segnext_state_dict_from_jax(sv))
    x = torch.from_numpy(images).float()
    mean = x.new_tensor(tseg.SEGNEXT_MEAN).reshape(1, 3, 1, 1)
    std = x.new_tensor(tseg.SEGNEXT_STD).reshape(1, 3, 1, 1)
    with torch.no_grad():
        logits = model((x - mean) / std).numpy()
    sv["params"]["decode_head"]["conv_seg"]["bias"] -= logits.mean(axis=(0, 2, 3))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp, torch_threads(2):
        mp.setitem(jseg.SEGNEXT_VARIANTS, "reduced", REDUCED)
        mp.setitem(tseg.SEGNEXT_VARIANTS, "reduced", REDUCED)
        jnet = JNet3(channels_last=True, **CFG)
        jsn = jseg.SegNeXt(variant="reduced")
        key = jax.random.PRNGKey(0)
        v = numpy_variables(jax.eval_shape(lambda: jnet.init(
            {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)),
            jnp.zeros((1, 12, S, S)), latent_avg=jnp.zeros((10, 512)),
            randomize_noise=False,
        )), seed=3)
        sv = numpy_variables(
            jax.eval_shape(lambda: jsn.init(key, jnp.zeros((1, 3, S, S)))), seed=5)
        d = tmp_path_factory.mktemp("ckpt")
        files, landmarks, crop_ref, (s_crop, t_crop) = _crop_pair(d)
        rng = np.random.RandomState(8)
        src = np.concatenate([_blocks(rng, 2), s_crop])
        tgt = np.concatenate([_blocks(rng, 2), t_crop])
        _calibrate_classifier(sv, np.concatenate([src, tgt]))
        latent_avg = rng.randn(10, 512).astype(np.float32)
        fn = jax.jit(j_make_swap_e2e(jnet, jsn, parser_size=S, taxonomy="celeba19",
                                     lap_bld=True))

        def want(s2, t2):
            """The JAX result of a batch of 2 (numpy)."""
            return [np.asarray(a) for a in fn(v, sv, s2, t2, latent_avg)]

        chunk0 = want(src[:2], tgt[:2])
        alone2 = want(src[2:].repeat(2, 0), tgt[2:].repeat(2, 0))
        ckpts = dict(checkpoint_path=str(d / "net3.pt"),
                     faceParsing_ckpt=str(d / "segnext.pth"))
        torch.save({"state_dict": net3_state_dict_from_jax(v),
                    "latent_avg": torch.from_numpy(latent_avg)},
                   ckpts["checkpoint_path"])
        torch.save({"state_dict": segnext_state_dict_from_jax(sv)},
                   ckpts["faceParsing_ckpt"])
        swapper = FaceSwapper(_opts(ckpts), device="cpu")
        yield dict(jnet=jnet, v=v, sv=sv, src=src, tgt=tgt, latent_avg=latent_avg,
                   chunk0=chunk0, alone2=alone2, ckpts=ckpts, swapper=swapper,
                   files=files, landmarks=landmarks, crop_ref=crop_ref)


def test_swap_e2e_segnext_lap_bld_matches_jax(case):
    swapper = case["swapper"]  # its models hold the shared weights
    with torch_threads(2):
        got = swap_core.make_swap_e2e(swapper.net, swapper.parser.model,
                                      parser_size=S, taxonomy="celeba19",
                                      lap_bld=True)(
            torch.from_numpy(case["src"][:2]), torch.from_numpy(case["tgt"][:2]),
            torch.from_numpy(case["latent_avg"]))
    out_u8, s_lab, hole, d_lab, t_lab = (g.numpy() for g in got)
    w_u8, w_s, w_hole, w_d, w_t = case["chunk0"]
    for g, w in ((d_lab, w_d), (t_lab, w_t), (s_lab, w_s)):
        assert np.mean(g == w) >= 0.999
    assert len(np.unique(w_s)) >= 3  # the parse is not degenerate
    assert np.mean(hole == w_hole) >= 0.999
    assert out_u8.shape == (2, 3, S, S) and out_u8.dtype == np.uint8
    assert psnr_u8(out_u8, w_u8) >= 40.0


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_swap_batch_pads_its_last_chunk_as_jax(case, dtype):
    """N = 3 pairs in chunks of 2: the last chunk is pair 2 twice."""
    want = np.concatenate([case["chunk0"][0], case["alone2"][0][:1]])
    src, tgt = case["src"], case["tgt"]
    if dtype == "float32":
        src, tgt = src / np.float32(255), tgt / np.float32(255)
    with torch_threads(2):
        got = case["swapper"].swap_batch(src, tgt, chunk=2)
    assert got.dtype == np.dtype(dtype) and got.shape == (3, 3, S, S)
    if dtype == "float32":
        got = np.round(got * 255.0)
    assert psnr_u8(got, want) >= 40.0


def test_staged_target_mask_path_matches_jax(case, tmp_path):
    """Given the JAX parse of the target as the target mask, the staged path
    (host parse and mask swap, swap core, host blend) gives the fused
    result; ``verbose`` writes the five mask images."""
    w_u8, w_s, _, _, w_t = case["alone2"]
    with torch_threads(2):
        img = case["swapper"].swap_from_arrays(
            case["src"][2:] / 255.0, case["tgt"][2:] / 255.0,
            target_mask=w_t[0].astype(np.uint8), save_dir=str(tmp_path),
            verbose=True)
    got = np.transpose(np.asarray(img), (2, 0, 1))[None]
    assert psnr_u8(got, w_u8[:1]) >= 40.0
    names = ("T_mask.png", "D_mask.png", "T_mask_vis.png", "swappedMask.png",
             "swappedMaskVis.png")
    assert sorted(os.listdir(tmp_path)) == sorted(names)
    swapped = np.asarray(Image.open(tmp_path / "swappedMask.png"))
    assert np.mean(swapped == w_s[0]) >= 0.999


def test_crop_path_matches_jax(case):
    """need_crop with given landmarks: the crops equal the JAX package's,
    and the swapped crop pasted back into the target frame matches."""
    files, landmarks = case["files"], case["landmarks"]
    crops, origs, _, inv = case["crop_ref"]
    t_crops, _, _, t_inv = alignment.crop_and_align_face(
        files, image_size=S, landmarks=landmarks)
    for a, b in zip(crops, t_crops):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(inv[1], t_inv[1])
    w_u8 = case["alone2"][0]  # the JAX swap of this very crop pair
    face = Image.fromarray(np.transpose(w_u8[0], (1, 2, 0))).convert("RGBA")
    want = origs[1].convert("RGBA")
    want.alpha_composite(face.transform(origs[1].size, Image.PERSPECTIVE, inv[1],
                                        Image.BILINEAR))
    with torch_threads(2):
        got = case["swapper"].swap(files[0][1], files[1][1], need_crop=True,
                                   landmarks=landmarks)
    assert got.size == origs[1].size
    assert psnr_u8(np.asarray(got), np.asarray(want)) >= 40.0


def test_cli_on_the_cpu_matches_jax(case, tmp_path):
    paths = []
    for name, img in (("src", case["src"][2]), ("tgt", case["tgt"][2])):
        paths.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(np.transpose(img, (1, 2, 0))).save(paths[-1])
    out_dir = tmp_path / "out"
    args = ["--source", paths[0], "--target", paths[1], "--output_dir", str(out_dir),
            "--device", "cpu", "--lap_bld", "--faceParser_name", "segnext",
            "--checkpoint_path", case["ckpts"]["checkpoint_path"],
            "--faceParsing_ckpt", case["ckpts"]["faceParsing_ckpt"],
            "--out_size", str(S), "--remaining_layer_idx", "7", "--n_styles", "10"]
    opts = cli.SwapFacePipelineOptions().parse(args)
    # the test's reduced models: a 64^2 encoder and parse (512 and 256 in use)
    opts.encoder_size = opts.parser_size = S
    with torch_threads(2):
        cli.run(opts)
    got = np.asarray(Image.open(out_dir / "swap_src_to_tgt.png"))
    want = np.transpose(case["alone2"][0][0], (1, 2, 0))
    assert psnr_u8(got, want) >= 40.0


def test_cli_refuses_bf16_and_needs_a_card_unless_cpu_is_asked(case, tmp_path,
                                                                monkeypatch):
    """``--bf16`` now runs (the name dates from when it was refused): the
    CLI with ``--bf16 --device cpu`` at 64^2 swaps with Net3 in bfloat16,
    >= 40 dB PSNR against the JAX package's f32 result; a flag nothing
    reads and a run without a card and without ``--device cpu`` are still
    refused."""
    paths = []
    for name, img in (("src", case["src"][2]), ("tgt", case["tgt"][2])):
        paths.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(np.transpose(img, (1, 2, 0))).save(paths[-1])
    out_dir = tmp_path / "out"
    opts = cli.SwapFacePipelineOptions().parse([
        "--source", paths[0], "--target", paths[1], "--output_dir", str(out_dir),
        "--bf16", "--device", "cpu", "--lap_bld", "--faceParser_name", "segnext",
        "--checkpoint_path", case["ckpts"]["checkpoint_path"],
        "--faceParsing_ckpt", case["ckpts"]["faceParsing_ckpt"],
        "--out_size", str(S), "--remaining_layer_idx", "7", "--n_styles", "10"])
    opts.encoder_size = opts.parser_size = S
    with torch_threads(2):
        cli.run(opts)
    got = np.asarray(Image.open(out_dir / "swap_src_to_tgt.png"))
    want = np.transpose(case["alone2"][0][0], (1, 2, 0))
    assert psnr_u8(got, want) >= 40.0
    with pytest.raises(SystemExit):  # a JAX flag that nothing reads
        cli.main(["--outer_dilation", "15", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--out_size", "64", "--checkpoint_path", ""])


def test_reconstruct_core_matches_jax(case):
    """Encode and regenerate under the face's own mask (the JAX parse of
    source 0): the port's ``reconstruct_core`` against the JAX one, 1e-4
    relative max."""
    img = case["src"][:1].astype(np.float32) / 127.5 - 1.0
    lab = case["chunk0"][3][:1, None]
    onehot = (lab == np.arange(12)[None, :, None, None]).astype(np.float32)
    want = np.asarray(jax.jit(j_reconstruct_core(case["jnet"]))(
        case["v"], img, onehot, case["latent_avg"]))
    with torch_threads(2):
        got = swap_core.reconstruct_core(case["swapper"].net)(
            torch.from_numpy(img), torch.from_numpy(onehot),
            torch.from_numpy(case["latent_avg"]))
    assert got.shape == want.shape == (1, 3, S, S)
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("helper", ["swap_head_mask", "swap_comp_style_vector",
                                    "label_maps", "img_utils"])
def test_host_helpers_equal_the_jax_package(helper):
    """The port's numpy copies give the JAX package's results bit for bit."""
    rng = np.random.RandomState(10)
    if helper == "swap_head_mask":
        from e4s_tpu.utils.swap_mask import swap_head_mask as j
        from e4s_tpu_torch.utils.swap_mask import swap_head_mask as t

        src, tgt = rng.randint(0, 12, (2, 32, 32)).astype(np.uint8)
        for hair_first in (True, False):
            for a, b in zip(t(src, tgt, hair_first), j(src, tgt, hair_first)):
                np.testing.assert_array_equal(a, b)
    elif helper == "swap_comp_style_vector":
        from e4s_tpu.utils.swap_mask import swap_comp_style_vector as j
        from e4s_tpu_torch.utils.swap_mask import swap_comp_style_vector as t

        sv1, sv2 = rng.randn(2, 1, 12, 8).astype(np.float32)
        sv2[:, 7] = 0
        for below in (False, True):
            np.testing.assert_array_equal(
                t(sv1, sv2, swap_core.SWAP_COMP_INDICES, below),
                j(sv1, sv2, swap_core.SWAP_COMP_INDICES, below))
    elif helper == "label_maps":
        from e4s_tpu.datasets import dataset as j
        from e4s_tpu_torch.utils import label_maps as t

        m = rng.randint(0, 19, (16, 16)).astype(np.uint8)
        for name in ("ffhq_mask_to_faceparser_mask_detailed",
                     "celebahq_mask_to_faceparser_mask_detailed"):
            np.testing.assert_array_equal(getattr(t, name)(m), getattr(j, name)(m))
    else:
        from e4s_tpu.utils import img_utils as j
        from e4s_tpu_torch.utils import img_utils as t

        m = rng.randint(0, 19, (16, 16))
        np.testing.assert_array_equal(t.vis_mask_in_color(m), j.vis_mask_in_color(m))
        x = rng.uniform(-1.2, 1.2, (3, 8, 8)).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(t.tensor2im(x)),
                                      np.asarray(j.tensor2im(x)))
