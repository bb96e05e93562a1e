"""The port's texture editing (``e4s_tpu_torch.pipelines.face_edit``)
against the JAX package's ``Editor`` at shared weights, f32 on the CPU:
out_size 64, K = 7, 10 styles, BiSeNet parsing at 512^2 (the JAX sweep's
fixed parse size), the example ``faceedit`` pair. The JAX ``Editor`` is
built as it is, its ``load_net3`` and ``load_face_parser`` handed the
shared weights instead of initialising; the port loads the same weights as
reference-format checkpoints. Results must agree to >= 40 dB PSNR on uint8;
the fixed noise bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, psnr_u8, torch_threads

import e4s_tpu.pipelines.face_edit as jedit
from e4s_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s_tpu.models.bisenet import FaceParser as JFaceParser
from e4s_tpu.models.net3 import Net3 as JNet3

from e4s_tpu_torch.cli import face_edit as cli
from e4s_tpu_torch.convert import bisenet_state_dict_from_jax, net3_state_dict_from_jax
from e4s_tpu_torch.pipelines import face_edit

S = 64
CFG = dict(out_size=S, remaining_layer_idx=7, n_styles=10)
REGIONS = ["hair", "eyes", "skin"]
ALPHAS = [0.0, 0.4, 0.8, 1.0]


def _opts(**kw):
    return types.SimpleNamespace(
        num_seg_cls=12, start_from_latent_avg=True, regions=REGIONS, alpha=0.6,
        source="example/input/faceedit/source.jpg",
        reference="example/input/faceedit/reference.jpg", **CFG, **kw)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp, torch_threads(2):
        jnet = JNet3(channels_last=True, encoder_size=S, **CFG)
        jbis = JBiSeNet(n_classes=19)
        key = jax.random.PRNGKey(0)
        v = numpy_variables(jax.eval_shape(lambda: jnet.init(
            {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)),
            jnp.zeros((1, 12, S, S)), latent_avg=jnp.zeros((10, 512)),
            randomize_noise=False)), seed=11)
        bv = numpy_variables(
            jax.eval_shape(lambda: jbis.init(key, jnp.zeros((1, 3, S, S)))), seed=12)
        latent_avg = np.random.RandomState(13).randn(10, 512).astype(np.float32)
        mp.setattr(jedit, "load_net3",
                   lambda opts: (jnet, v, jnp.asarray(latent_avg)))
        mp.setattr(jedit, "load_face_parser",
                   lambda opts, ckpt: JFaceParser(variables=bv, size=S))
        je = jedit.Editor(_opts())
        want_sweep = [np.asarray(im) for im in je.interpolation_sweep(ALPHAS)]
        want_one = np.asarray(je.interpolation())

        d = tmp_path_factory.mktemp("ckpt")
        ckpts = dict(checkpoint_path=str(d / "net3.pt"),
                     faceParsing_ckpt=str(d / "bisenet.pth"))
        torch.save({"state_dict": net3_state_dict_from_jax(v),
                    "latent_avg": torch.from_numpy(latent_avg)},
                   ckpts["checkpoint_path"])
        torch.save(bisenet_state_dict_from_jax(bv), ckpts["faceParsing_ckpt"])
        editor = face_edit.Editor(_opts(encoder_size=S, **ckpts), device="cpu")
        yield dict(editor=editor, ckpts=ckpts, want_sweep=want_sweep,
                   want_one=want_one)


@pytest.mark.parametrize("out_size", [64, 256])
def test_sample_fixed_noise_is_the_jax_draw(out_size):
    want = jedit.sample_fixed_noise(out_size)
    got = face_edit.sample_fixed_noise(out_size)
    assert len(got) == len(want) == 2 * int(np.log2(out_size)) - 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape[1] > 1  # full channel
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_interpolation_sweep_matches_jax(case):
    """A = 4 alphas over three regions: one parse of both faces and one
    batch of four edits, against the JAX ``Editor.interpolation_sweep``."""
    with torch_threads(2):
        got = case["editor"].interpolation_sweep(ALPHAS)
    assert len(got) == len(ALPHAS)
    for g, w in zip(got, case["want_sweep"]):
        assert g.size == (S, S)
        assert psnr_u8(np.asarray(g), w) >= 40.0
    # the alphas move the result: alpha 0 is not alpha 1
    assert psnr_u8(np.asarray(got[0]), np.asarray(got[-1])) < 40.0


def test_interpolation_matches_jax(case):
    """One alpha from image files with the host parse (the CLI's path),
    against the JAX ``Editor.interpolation``."""
    with torch_threads(2):
        got = np.asarray(case["editor"].interpolation())
    assert got.shape == (S, S, 3)
    assert psnr_u8(got, case["want_one"]) >= 40.0


def test_cli_on_the_cpu_matches_jax(case, tmp_path):
    out_dir = tmp_path / "out"
    args = ["--regions", *REGIONS, "--alpha", "0.6", "--device", "cpu",
            "--output_dir", str(out_dir),
            "--checkpoint_path", case["ckpts"]["checkpoint_path"],
            "--faceParsing_ckpt", case["ckpts"]["faceParsing_ckpt"],
            "--out_size", str(S), "--remaining_layer_idx", "7", "--n_styles", "10"]
    opts = cli.EditOptions().parse(args)
    opts.encoder_size = S  # the test's reduced encoder (256 in use)
    with torch_threads(2):
        cli.run(opts)
    from PIL import Image

    got = np.asarray(Image.open(out_dir / "edit_res.png"))
    assert psnr_u8(got, case["want_one"]) >= 40.0


def test_editor_refuses_unknown_regions_and_needs_a_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown region"):
        face_edit.Editor(types.SimpleNamespace(regions=["beard"]), device="cpu")
    with pytest.raises(SystemExit):  # a JAX flag that nothing reads
        cli.main(["--regions", "hair", "--train_G", "true"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--regions", "hair", "--out_size", "64", "--checkpoint_path", ""])
