"""The port's SegNeXt parser (``e4s_tpu_torch/models/segnext.py``) against
the JAX package's at shared numpy weights, f32 on the CPU: every module
within 1e-4 relative max (the Hamburger alone within 5e-4, see
``HAMBURGER_TOL``); a whole reduced SegNeXt (depth 1 per stage, narrow
stages, registered in both variant tables for the test) within 1e-4 on the
logits and on >= 99.9% of the labels. Also the packaged NMF bases (bitwise
the JAX expression), the mmseg checkpoint round trip and the parser's
loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, rel_err, torch_threads

import e4s_tpu.models.segnext as J
from e4s_tpu.utils.torch_convert import convert_segnext
from e4s_tpu.utils.torch_convert import segnext_variant_from_sd as j_variant_from_sd

import e4s_tpu_torch.models.segnext as T
from e4s_tpu_torch.convert import segnext_state_dict_from_jax, segnext_variant_from_sd
from e4s_tpu_torch.pipelines.model_io import load_face_parser, materialise

TOL = 1e-4
REDUCED = dict(embed_dims=(16, 32, 32, 64), depths=(1, 1, 1, 1),
               mlp_ratios=(2, 2, 2, 2), head_in=(32, 32, 64), ham_channels=256)


def _pair(jmod, tmod, *xs, seed=0):
    """Seeded numpy variables for the JAX module at the inputs' shapes, and
    the port module with the same weights."""
    key = jax.random.PRNGKey(0)
    v = numpy_variables(jax.eval_shape(lambda: jmod.init(key, *xs)), seed=seed)
    return v, materialise(tmod, segnext_state_dict_from_jax(
        {"params": v["params"], "batch_stats": v.get("batch_stats", {})}))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# The Hamburger alone takes a looser bound, forced by its NMF start
# softmax(100 x^T B): one f32 ulp of x^T B (up to ~8 here) moves the
# softmax logits by ~5e-5, and the multiplicative updates carry it on; each
# f32 version, the JAX one included, is 6-7e-5 off an f64 evaluation at
# these inputs, and the GroupNorm after it rescales the difference.
HAMBURGER_TOL = 5e-4
MODULES = {
    "DWConv": (lambda: J.DWConv(1, 11), lambda: T.DWConv(16, 1, 11),
               (2, 16, 12, 12), TOL),
    "MSCAAttention": (J.MSCAAttention, lambda: T.MSCAAttention(16),
                      (2, 16, 12, 12), TOL),
    "MSCABlock": (lambda: J.MSCABlock(16, 2), lambda: T.MSCABlock(16, 2),
                  (2, 16, 12, 12), TOL),
    "GroupNorm32": (lambda: J.GroupNorm32(64), lambda: T.GroupNorm32(64),
                    (2, 64, 6, 6), TOL),
    "Hamburger": (lambda: J.Hamburger(256), lambda: T.Hamburger(256),
                  (2, 256, 8, 8), HAMBURGER_TOL),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    jctor, tctor, shape, tol = MODULES[name]
    x = _x(1, *shape)
    jmod = jctor()
    v, tmod = _pair(jmod, tctor, x)
    want = np.asarray(jax.jit(jmod.apply)(v, x))
    with torch.no_grad():
        assert rel_err(tmod(torch.from_numpy(x)), want) < tol


def test_nmf2d_matches_jax():
    rng = np.random.RandomState(2)
    x = np.abs(rng.randn(2, 32, 40)).astype(np.float32)
    bases = rng.rand(2, 32, 16).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    want = np.asarray(jax.jit(J.nmf2d)(x, bases))
    assert rel_err(T.nmf2d(torch.from_numpy(x), torch.from_numpy(bases)), want) < TOL


@pytest.mark.parametrize("channels", [256, 512, 1024])
def test_nmf_bases_are_the_jax_draw_bitwise(channels):
    """The constant shipped for the NMF start is the JAX package's
    ``Hamburger`` expression, bit for bit."""
    b = jax.random.uniform(jax.random.PRNGKey(0), (1, channels, 16))
    b = b / (jnp.linalg.norm(b, axis=1, keepdims=True) + 1e-6)
    np.testing.assert_array_equal(T.nmf_bases(channels), np.asarray(b))


@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setitem(J.SEGNEXT_VARIANTS, "reduced", REDUCED)
    monkeypatch.setitem(T.SEGNEXT_VARIANTS, "reduced", REDUCED)


def _centred_labels(logits):
    """Labels after centring each class's logits over the batch: with
    random weights one class would win everywhere."""
    logits = np.asarray(logits)
    return (logits - logits.mean(axis=(0, 2, 3), keepdims=True)).argmax(axis=1)


def test_mscan_and_head_match_jax(reduced):
    cfg = REDUCED
    x = _x(3, 2, 3, 64, 64)
    jmsc = J.MSCAN(cfg["embed_dims"], cfg["depths"], cfg["mlp_ratios"])
    v, tmsc = _pair(jmsc, lambda: T.MSCAN(cfg["embed_dims"], cfg["depths"],
                                          cfg["mlp_ratios"]), x)
    want = jax.jit(jmsc.apply)(v, x)
    with torch.no_grad():
        got = tmsc(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert rel_err(g, w) < TOL
    feats = [np.array(w) for w in want]
    jhead = J.LightHamHead(19, 256, 256)
    hv, thead = _pair(jhead, lambda: T.LightHamHead(cfg["head_in"]), feats, seed=1)
    want = np.asarray(jax.jit(jhead.apply)(hv, feats))
    with torch.no_grad():
        assert rel_err(thead([torch.from_numpy(f) for f in feats]), want) < TOL


def test_segnext_logits_and_labels_match_jax(reduced):
    x = _x(4, 2, 3, 64, 64) * 1.5
    jm = J.SegNeXt(variant="reduced")
    v, tm = _pair(jm, lambda: T.SegNeXt("reduced"), x, seed=5)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad(), torch_threads(2):
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 19, 64, 64)
    assert rel_err(got, want) < TOL
    labels = _centred_labels(want)
    assert len(np.unique(labels)) >= 3
    assert np.mean(_centred_labels(got) == labels) >= 0.999


def _mmseg_tiny_state_dict(seed=0):
    """An mmseg-style SegNeXt-tiny state dict (official key names and
    shapes; a copy of the JAX package's test builder)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = rng.randn(*shape).astype(np.float32) * 0.05

    def conv(name, o, i, kh, kw, bias=True):
        put(name + ".weight", o, i, kh, kw)
        if bias:
            put(name + ".bias", o)

    def bn(name, c):
        put(name + ".weight", c)
        put(name + ".bias", c)
        put(name + ".running_mean", c)
        sd[name + ".running_var"] = np.abs(rng.randn(c)).astype(np.float32) + 0.5
        sd[name + ".num_batches_tracked"] = np.int64(1000)

    dims, depths, ratios = (32, 64, 160, 256), (3, 3, 5, 2), (8, 8, 4, 4)
    conv("backbone.patch_embed1.proj.0", dims[0] // 2, 3, 3, 3)
    bn("backbone.patch_embed1.proj.1", dims[0] // 2)
    conv("backbone.patch_embed1.proj.3", dims[0], dims[0] // 2, 3, 3)
    bn("backbone.patch_embed1.proj.4", dims[0])
    for s in (2, 3, 4):
        conv(f"backbone.patch_embed{s}.proj", dims[s - 1], dims[s - 2], 3, 3)
        bn(f"backbone.patch_embed{s}.norm", dims[s - 1])
    for s in range(1, 5):
        d, r = dims[s - 1], ratios[s - 1]
        for b in range(depths[s - 1]):
            p = f"backbone.block{s}.{b}"
            put(f"{p}.layer_scale_1", d)
            put(f"{p}.layer_scale_2", d)
            bn(f"{p}.norm1", d)
            bn(f"{p}.norm2", d)
            conv(f"{p}.attn.proj_1", d, d, 1, 1)
            conv(f"{p}.attn.proj_2", d, d, 1, 1)
            sg = f"{p}.attn.spatial_gating_unit"
            conv(f"{sg}.conv0", d, 1, 5, 5)
            conv(f"{sg}.conv0_1", d, 1, 1, 7)
            conv(f"{sg}.conv0_2", d, 1, 7, 1)
            conv(f"{sg}.conv1_1", d, 1, 1, 11)
            conv(f"{sg}.conv1_2", d, 1, 11, 1)
            conv(f"{sg}.conv2_1", d, 1, 1, 21)
            conv(f"{sg}.conv2_2", d, 1, 21, 1)
            conv(f"{sg}.conv3", d, d, 1, 1)
            conv(f"{p}.mlp.fc1", d * r, d, 1, 1)
            conv(f"{p}.mlp.dwconv.dwconv", d * r, 1, 3, 3)
            conv(f"{p}.mlp.fc2", d, d * r, 1, 1)
        put(f"backbone.norm{s}.weight", d)
        put(f"backbone.norm{s}.bias", d)

    ham, ch = 256, 256
    head_in = 64 + 160 + 256
    conv("decode_head.squeeze.conv", ham, head_in, 1, 1, bias=False)
    put("decode_head.squeeze.gn.weight", ham)
    put("decode_head.squeeze.gn.bias", ham)
    conv("decode_head.hamburger.ham_in.conv", ham, ham, 1, 1)
    conv("decode_head.hamburger.ham_out.conv", ham, ham, 1, 1, bias=False)
    put("decode_head.hamburger.ham_out.gn.weight", ham)
    put("decode_head.hamburger.ham_out.gn.bias", ham)
    conv("decode_head.align.conv", ch, ham, 1, 1, bias=False)
    put("decode_head.align.gn.weight", ch)
    put("decode_head.align.gn.bias", ch)
    conv("decode_head.conv_seg", 19, ch, 1, 1)
    return sd


def test_state_dict_round_trips_through_the_jax_converter():
    """segnext_state_dict_from_jax(convert_segnext(sd)) is the mmseg sd, key
    for key (``num_batches_tracked``, which the JAX tree drops, comes back
    as 0), and the variant is inferred as the JAX package infers it."""
    sd = _mmseg_tiny_state_dict()
    params, stats = convert_segnext(sd, J.SEGNEXT_VARIANTS["tiny"]["depths"])
    back = segnext_state_dict_from_jax({"params": params, "batch_stats": stats})
    assert set(back) == set(sd)
    for k, v in sd.items():
        want = 0 if k.endswith("num_batches_tracked") else v
        np.testing.assert_array_equal(back[k].numpy(), want)
    assert segnext_variant_from_sd(sd) == j_variant_from_sd(sd) == "tiny"


def test_load_face_parser_loads_an_mmseg_pth(tmp_path):
    """An mmseg checkpoint ({"state_dict": ...}, with ``module.`` prefixes)
    loads with ``load_state_dict``; the variant comes from the checkpoint."""
    import types

    sd = {k: torch.as_tensor(v) for k, v in _mmseg_tiny_state_dict().items()}
    path = tmp_path / "segnext.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    opts = types.SimpleNamespace(faceParser_name="segnext", out_size=64,
                                 segnext_config="segnext.small.512x512.py",
                                 parser_size=64)
    parser = load_face_parser(opts, str(path), device="cpu")
    assert parser.taxonomy == "celeba19" and parser.parser_size == 64
    assert parser.model.variant == "tiny"
    got = parser.model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v)
    labels = parser(torch.rand(1, 3, 64, 64))
    assert labels.shape == (1, 64, 64) and labels.max() < 19
