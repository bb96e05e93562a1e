"""Models of the PyTorch port (e4s_tpu_torch.models) against the JAX package
at shared weights: the mask-guided Generator (32^2, K=7), the RGI encoder
(64^2 input), the whole Net3 forward and BiSeNet's logits (64^2). All f32 on
the CPU, to 1e-4 of the reference's max |value|. The weights are drawn once
per module with numpy (tests/torch_port_helpers.py); each JAX stage is
jitted and compiled once for the module."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, rel_err, torch_threads

from e4s_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s_tpu.models.bisenet import bicubic_downsample as j_bicubic
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.utils import torch_convert

from e4s_tpu_torch.convert import (
    bisenet_state_dict_from_jax,
    generator_state_dict_from_jax,
    net3_state_dict_from_jax,
)
from e4s_tpu_torch.models.bisenet import BiSeNet, bicubic_downsample
from e4s_tpu_torch.models.net3 import Net3
from e4s_tpu_torch.models.stylegan2 import Generator
from e4s_tpu_torch.pipelines.model_io import materialise

TOL = 1e-4
KEYMAPS = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_keymaps"
CFG = dict(out_size=32, remaining_layer_idx=7, n_styles=8, encoder_size=64)


@pytest.fixture(scope="module")
def case():
    with torch_threads(2):
        jnet = JNet3(channels_last=True, **CFG)
        jbis = JBiSeNet(n_classes=19)
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jnet.init(
            {"params": key, "noise": key}, jnp.zeros((1, 3, 64, 64)),
            jnp.zeros((1, 12, 64, 64)), latent_avg=jnp.zeros((8, 512)),
            randomize_noise=False,
        ))
        v = numpy_variables(shapes, seed=0)
        bv = numpy_variables(
            jax.eval_shape(lambda: jbis.init(key, jnp.zeros((1, 3, 64, 64)))),
            seed=1,
        )
        rng = np.random.RandomState(2)
        img = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
        lab = np.kron(rng.randint(0, 12, (2, 8, 8)), np.ones((8, 8), int))
        mask = (lab[:, None] == np.arange(12)[None, :, None, None]).astype(np.float32)
        latent_avg = rng.randn(8, 512).astype(np.float32)
        codes = rng.randn(2, 12, 8, 512).astype(np.float32)
        struc = np.zeros((2, 512, 32, 32), np.float32)

        # Net3.__call__ is encode -> codes -> G; jitted per stage so the
        # trunk and the generator each compile once
        enc = jax.jit(lambda v, x, m: jnet.apply(
            v, x, m, method=JNet3.get_style_vectors)[0])
        to_codes = jax.jit(lambda v, sv, la: jnet.apply(
            v, sv, la, method=JNet3.cal_style_codes))
        gen = jax.jit(lambda v, c, m: jnet.apply(
            v, struc, c, m, method=JNet3.gen_img, randomize_noise=False)[0])
        sv = enc(v, img, mask)
        want = [np.asarray(a) for a in (
            gen(v, codes, mask), sv, gen(v, to_codes(v, sv, latent_avg), mask))]
        want.append([np.asarray(a) for a in jax.jit(jbis.apply)(bv, img)])
        net = materialise(lambda: Net3(**CFG), net3_state_dict_from_jax(v),
                           0, "cpu")
        bis = materialise(lambda: BiSeNet(19), bisenet_state_dict_from_jax(bv),
                           0, "cpu")
        t = {k: torch.from_numpy(a) for k, a in dict(
            img=img, mask=mask, latent_avg=latent_avg, codes=codes,
            struc=struc).items()}
        yield dict(v=v, bv=bv, want=want, net=net, bis=bis, t=t)


def test_generator_matches_jax(case):
    t, net = case["t"], case["net"]
    with torch_threads(2), torch.no_grad():
        face, _, _ = net.gen_img(t["struc"], t["codes"], t["mask"],
                                 randomize_noise=False)
    assert face.shape == (2, 3, 32, 32)
    assert rel_err(face, case["want"][0]) < TOL


def test_generator_alone_matches_jax(case):
    """The Generator as its own module, from the G subtree."""
    v, t = case["v"], case["t"]
    g = materialise(
        lambda: Generator(32, remaining_layer_idx=7),
        generator_state_dict_from_jax(
            {"params": v["params"]["G"], "noises": v["noises"]["G"]}),
        0, "cpu",
    )
    with torch_threads(2), torch.no_grad():
        face, _, _ = g([t["codes"]], None, t["mask"], input_is_latent=True,
                       randomize_noise=False)
    assert rel_err(face, case["want"][0]) < TOL


def test_fsencoder_matches_jax(case):
    t, net = case["t"], case["net"]
    with torch_threads(2), torch.no_grad():
        sv, struc = net.get_style_vectors(t["img"], t["mask"])
    assert sv.shape == (2, 12, 1280) and struc.abs().max() == 0
    assert rel_err(sv, case["want"][1]) < TOL


def test_net3_forward_matches_jax(case):
    t, net = case["t"], case["net"]
    with torch_threads(2), torch.no_grad():
        full, _ = net(t["img"], t["mask"], latent_avg=t["latent_avg"],
                      randomize_noise=False)
    assert rel_err(full, case["want"][2]) < TOL


def test_bisenet_logits_match_jax(case):
    t, bis = case["t"], case["bis"]
    with torch_threads(2), torch.no_grad():
        outs = bis(t["img"])
    for got, want in zip(outs, case["want"][3]):
        assert got.shape == want.shape
        assert rel_err(got, want) < TOL


@pytest.mark.parametrize("factor,clip_round", [(2, False), (4, True)])
def test_bicubic_downsample_matches_jax(factor, clip_round):
    """The parser's 1024 -> 512 input path (factor 2 on the main path)."""
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 255 if clip_round else 1, (2, 3, 32, 40)).astype(np.float32)
    want = np.asarray(j_bicubic(jnp.asarray(x), factor, clip_round=clip_round))
    got = bicubic_downsample(torch.from_numpy(x), factor, clip_round=clip_round)
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_converter_round_trips_net3(case):
    back = torch_convert.convert_net3_state_dict(net3_state_dict_from_jax(case["v"]))
    _assert_same_tree(back, case["v"])


def test_converter_round_trips_bisenet(case):
    params, stats = torch_convert.convert_bisenet(
        bisenet_state_dict_from_jax(case["bv"]))
    _assert_same_tree({"params": params, "batch_stats": stats}, case["bv"])


@pytest.mark.parametrize("build,fixture", [
    (lambda: Net3(), "net3_state_dict"),
    (lambda: Generator(1024), "stylegan2_generator"),
    (lambda: BiSeNet(19), "bisenet"),
])
def test_state_dict_keys_are_the_reference(build, fixture):
    with torch.device("meta"):
        model = build()
    want = json.loads((KEYMAPS / f"{fixture}.json").read_text())
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == want
