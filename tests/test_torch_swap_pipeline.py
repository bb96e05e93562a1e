"""``faceSwapping_pipeline``, the port's functional swap entry, at 256^2
(K=13, 14 styles, published widths, seeded weights saved as the
reference's checkpoint files, which both packages load): exactly the uint8
result of the port's ``FaceSwapper.swap``, and the JAX
``faceSwapping_pipeline``'s at >= 40 dB (the bar of
``tests/test_torch_swap.py``)."""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_port_helpers import numpy_variables, psnr_u8, torch_threads

from e4s_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.pipelines.face_swap import faceSwapping_pipeline as j_pipeline

from e4s_tpu_torch.convert import bisenet_state_dict_from_jax, net3_state_dict_from_jax
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper, faceSwapping_pipeline

S = 256
CFG = dict(out_size=S, remaining_layer_idx=13, n_styles=14)
EXAMPLE = pathlib.Path(__file__).resolve().parent.parent / "example" / "input" / "faceswap"
SRC, TGT = str(EXAMPLE / "source.jpg"), str(EXAMPLE / "target.jpg")


def test_face_swapping_pipeline_matches_the_swapper_and_jax(tmp_path):
    key = jax.random.PRNGKey(0)
    v = numpy_variables(jax.eval_shape(lambda: JNet3(**CFG).init(
        {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)), jnp.zeros((1, 12, S, S)),
        latent_avg=jnp.zeros((14, 512)), randomize_noise=False)), seed=7)
    bv = numpy_variables(jax.eval_shape(
        lambda: JBiSeNet(n_classes=19).init(key, jnp.zeros((1, 3, 512, 512)))), seed=8)
    latent_avg = np.random.RandomState(9).randn(14, 512).astype(np.float32)
    ckpt, parser_ckpt = tmp_path / "net3.pt", tmp_path / "bisenet.pth"
    torch.save({"state_dict": net3_state_dict_from_jax(v),
                "latent_avg": torch.from_numpy(latent_avg)}, ckpt)
    torch.save(bisenet_state_dict_from_jax(bv), parser_ckpt)
    opts = types.SimpleNamespace(
        num_seg_cls=12, start_from_latent_avg=True, learn_in_w=False, bf16=False,
        lap_bld=False, checkpoint_path=str(ckpt), faceParsing_ckpt=str(parser_ckpt), **CFG)

    with torch_threads(4):
        got = faceSwapping_pipeline(SRC, TGT, opts, str(tmp_path / "port"), device="cpu")
        again = FaceSwapper(opts, device="cpu").swap(SRC, TGT)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(again))
    assert (tmp_path / "port" / "swap_source_to_target.png").exists()
    want = j_pipeline(SRC, TGT, opts, str(tmp_path / "jax"))
    assert np.asarray(got).shape == (S, S, 3)
    assert psnr_u8(np.asarray(got), np.asarray(want)) >= 40.0
