"""The port's fused swap (e4s_tpu_torch.pipelines) against the JAX package's
``make_swap_e2e`` at shared weights: out_size 64, parser 64^2, K=7, 10
styles, seeded uint8 images, f32 on the CPU. The parsed labels must agree on
>= 99.9% of pixels and the uint8 results to >= 40 dB PSNR, both through
``make_swap_e2e`` and through the user's entry point
``FaceSwapper(..., device="cpu").swap_from_arrays`` (which loads the shared
weights as reference-format checkpoints)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, psnr_u8, torch_threads

from e4s_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.pipelines.swap_core import make_swap_e2e as j_make_swap_e2e
from e4s_tpu.pipelines.swap_core import swap_head_mask_device as j_swap_mask
from e4s_tpu.pipelines.swap_core import (
    swap_style_vectors_device as j_swap_sv,
)

from e4s_tpu_torch.convert import (
    bisenet_state_dict_from_jax,
    net3_state_dict_from_jax,
)
from e4s_tpu_torch.models.bisenet import BiSeNet
from e4s_tpu_torch.models.net3 import Net3
from e4s_tpu_torch.pipelines import swap_core
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper
from e4s_tpu_torch.pipelines.model_io import materialise

CFG = dict(out_size=64, remaining_layer_idx=7, n_styles=10, encoder_size=64)
S = 64


def _opts(**kw):
    return types.SimpleNamespace(num_seg_cls=12, start_from_latent_avg=True,
                                 parser_size=S, **CFG, **kw)


@pytest.fixture(scope="module")
def case():
    with torch_threads(2):
        jnet = JNet3(channels_last=True, **CFG)
        jbis = JBiSeNet(n_classes=19)
        key = jax.random.PRNGKey(0)
        v = numpy_variables(jax.eval_shape(lambda: jnet.init(
            {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)),
            jnp.zeros((1, 12, S, S)), latent_avg=jnp.zeros((10, 512)),
            randomize_noise=False,
        )), seed=3)
        bv = numpy_variables(
            jax.eval_shape(lambda: jbis.init(key, jnp.zeros((1, 3, S, S)))),
            seed=4,
        )
        rng = np.random.RandomState(5)
        # seeded images of 8x8-pixel colour blocks
        src, tgt = (
            np.kron(rng.randint(0, 256, (1, 3, 8, 8)), np.ones((8, 8))).astype(np.uint8)
            for _ in range(2)
        )
        latent_avg = rng.randn(10, 512).astype(np.float32)
        fn = jax.jit(j_make_swap_e2e(jnet, jbis, parser_size=S))
        want = [np.asarray(a) for a in fn(v, bv, src, tgt, latent_avg)]
        net = materialise(lambda: Net3(**CFG), net3_state_dict_from_jax(v))
        bis = materialise(lambda: BiSeNet(19), bisenet_state_dict_from_jax(bv))
        got = swap_core.make_swap_e2e(net, bis, parser_size=S)(
            torch.from_numpy(src), torch.from_numpy(tgt),
            torch.from_numpy(latent_avg))
        yield dict(v=v, bv=bv, src=src, tgt=tgt, latent_avg=latent_avg,
                   want=want, net=net, got=got)


def test_swap_e2e_matches_jax(case):
    out_u8, s_lab, hole, d_lab, t_lab = (g.numpy() for g in case["got"])
    w_u8, w_s, w_hole, w_d, w_t = case["want"]
    for g, w in ((d_lab, w_d), (t_lab, w_t), (s_lab, w_s)):
        assert np.mean(g == w) >= 0.999
    assert len(np.unique(w_s)) >= 3  # the parse is not degenerate
    np.testing.assert_array_equal(hole, w_hole)
    assert out_u8.shape == (1, 3, S, S) and out_u8.dtype == np.uint8
    assert psnr_u8(out_u8, w_u8) >= 40.0


def test_swap_core_and_stitch_rebuild_the_e2e_result(case):
    """make_swap_core on the e2e's own labels, then the stitch and cast,
    give the fused result bit for bit."""
    out_u8, s_lab, hole, d_lab, t_lab = case["got"]
    driven, target = (torch.from_numpy(a).float() / 255.0 * 2.0 - 1.0
                      for a in (case["src"], case["tgt"]))
    core = swap_core.make_swap_core(case["net"], from_labels=True)
    with torch_threads(2):
        face = core(driven, target, d_lab[:, None], t_lab[:, None],
                    s_lab[:, None], torch.from_numpy(case["latent_avg"]))
        stitched = swap_core.stitch_foreground(face, target, s_lab[:, None],
                                               hole[:, None])
    u8 = (torch.clamp((stitched + 1.0) / 2.0, 0.0, 1.0) * 255.0).to(torch.uint8)
    assert torch.equal(u8, out_u8)


def test_face_swapper_cpu_matches_jax(case, tmp_path):
    """The entry point, from reference-format checkpoint files."""
    ckpt = tmp_path / "net3.pt"
    torch.save({"state_dict": net3_state_dict_from_jax(case["v"]),
                "latent_avg": torch.from_numpy(case["latent_avg"])}, ckpt)
    parser_ckpt = tmp_path / "bisenet.pth"
    torch.save(bisenet_state_dict_from_jax(case["bv"]), parser_ckpt)
    with torch_threads(2):
        swapper = FaceSwapper(
            _opts(checkpoint_path=str(ckpt), faceParsing_ckpt=str(parser_ckpt)),
            device="cpu",
        )
        img = swapper.swap_from_arrays(case["src"] / 255.0, case["tgt"] / 255.0)
    got = np.transpose(np.asarray(img), (2, 0, 1))[None]
    assert got.shape == (1, 3, S, S)
    assert psnr_u8(got, case["want"][0]) >= 40.0


def test_face_swapper_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaceSwapper(_opts(checkpoint_path=None))


def test_swap_head_mask_matches_jax():
    rng = np.random.RandomState(6)
    src, tgt = rng.randint(0, 12, (2, 2, 16, 16))
    tgt[0, :2] = 0
    want = [np.asarray(a) for a in j_swap_mask(jnp.asarray(src), jnp.asarray(tgt))]
    got = swap_core.swap_head_mask_device(torch.from_numpy(src), torch.from_numpy(tgt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("ear_absent", [False, True])
def test_swap_style_vectors_matches_jax(ear_absent):
    rng = np.random.RandomState(7)
    t_sv, d_sv = rng.randn(2, 2, 12, 16).astype(np.float32)
    d_sv[:, 9] = 0  # teeth absent in the source
    if ear_absent:
        d_sv[:, 7] = 0
    want = np.asarray(j_swap_sv(jnp.asarray(t_sv), jnp.asarray(d_sv)))
    got = swap_core.swap_style_vectors_device(torch.from_numpy(t_sv),
                                              torch.from_numpy(d_sv))
    np.testing.assert_array_equal(got.numpy(), want)
