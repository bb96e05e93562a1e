"""The port's latent inversion and its criteria against the JAX package, on
the CPU in f32, at shared numpy weights (``jax.eval_shape`` shapes):

- IR-SE50, LPIPS (alex and vgg), the parsing U-Net (logits and encoder
  features), ``IDLoss`` and ``FaceParsingLoss``, each against its JAX module
  at 1e-4 relative max; their converters round-trip through the JAX
  package's, and their keys are the reference checkpoints';
- the inversion loss (ID + L2 + three-scale LPIPS + parsing, the default
  weights) and its gradient with respect to the style vectors at one point,
  against ``jax.value_and_grad`` of the same composition built from the JAX
  modules (``cal_style_codes`` -> ``gen_img`` -> the criteria) at 64^2,
  K = 7, 10 styles: 1e-4 relative max. The point is seeded uniform style
  vectors, not the encoder's: a demodulated layer's output does not change
  when its style is scaled, so the gradient along the style cancels, and at
  the encoder's vectors (large styles) it cancels to ~1e-3 of its parts;
  both packages compute the demodulation in f32 by design, which leaves
  them 5e-4 apart there (5e-8 with the demodulation in f64 on both sides);
- the four optimizers against optax on a quadratic for 10 steps: 1e-6 of
  the largest parameter;
- ``Optimizer.invertion`` for 3 steps on the CPU, f32 and bf16 (finite
  losses, f32 style vectors and moments, the JAX package's files), and the
  CLI;
- the datasets' items and one-hots, bit for bit.
"""

import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, rel_err, torch_threads

from e4s_tpu.criteria import FaceParsingLoss as JFaceParsingLoss
from e4s_tpu.criteria import IDLoss as JIDLoss
from e4s_tpu.datasets import dataset as jds
from e4s_tpu.models.encoders import IRSE50Backbone as JIRSE50
from e4s_tpu.models.lpips_nets import LPIPS as JLPIPS
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.models.unet import ParsingUNet as JUNet
from e4s_tpu.ops.resize import adaptive_avg_pool2d as j_pool
from e4s_tpu.pipelines.optimization import make_optimizer
from e4s_tpu.utils import torch_convert as tc

from e4s_tpu_torch.cli import optimization as cli
from e4s_tpu_torch.convert import (
    irse50_state_dict_from_jax,
    lpips_state_dict_from_jax,
    net3_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from e4s_tpu_torch.criteria.id_loss import IDLoss
from e4s_tpu_torch.criteria.parsing_loss import FaceParsingLoss
from e4s_tpu_torch.datasets import dataset as tds
from e4s_tpu_torch.models.encoders import IRSE50Backbone
from e4s_tpu_torch.models.lpips_nets import LPIPS, AlexNetFeatures, VGG16Features
from e4s_tpu_torch.models.unet import ParsingUNet
from e4s_tpu_torch.pipelines.model_io import materialise
from e4s_tpu_torch.pipelines.optimization import OptaxRule, Optimizer

KEYMAPS = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_keymaps"
S = 64
CFG = dict(out_size=S, remaining_layer_idx=7, n_styles=10)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _variables(module, seed, *inputs):
    """Seeded numpy variables in the module's ``eval_shape`` shapes, with
    BatchNorm scales near 1 and every conv and the IR-SE50 embedding layer
    fan-in scaled, so activations stay in range through the deep trunks."""
    key = jax.random.PRNGKey(0)
    v = numpy_variables(jax.eval_shape(lambda: module.init(key, *inputs)), seed)
    rng = np.random.default_rng(seed + 100)

    def walk(node, name=""):
        for k, c in node.items():
            if isinstance(c, dict):
                if ("norm" in k or "bn" in k) and "weight" in c:
                    c["weight"] = (1 + 0.1 * rng.standard_normal(
                        c["weight"].shape)).astype(np.float32)
                walk(c, k)
            elif k == "output_linear_weight":
                node[k] = (c / np.sqrt(c.shape[1])).astype(np.float32)
            elif k in ("weight", "up_weight") and c.ndim == 4:
                node[k] = (rng.standard_normal(c.shape)
                           / np.sqrt(np.prod(c.shape[1:]))).astype(np.float32)

    walk(v["params"])
    return v


def _sub(v, name):
    return {coll: tree[name] for coll, tree in v.items()}


def _img(seed, shape=(1, 3, S, S)):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    x = jnp.zeros((1, 3, S, S))
    unet = _variables(JUNet(), 2, x)  # the whole U-Net; the loss reads its encoder
    return dict(
        id=_variables(JIDLoss(), 1, x, x),
        unet=unet,
        parsing={coll: {"G": tree} for coll, tree in unet.items()},
        alex=_variables(JLPIPS("alex"), 3, x, x),
        vgg=_variables(JLPIPS("vgg"), 4, x, x),
    )


def _port(name, v):
    """The port's module for criterion ``name`` with the JAX weights."""
    if name == "irse50":
        return materialise(IRSE50Backbone, irse50_state_dict_from_jax(_sub(v, "facenet")))
    if name == "id":
        return materialise(IDLoss, {f"facenet.{k}": t for k, t in
                                    irse50_state_dict_from_jax(_sub(v, "facenet")).items()})
    if name in ("unet", "parsing"):
        sd = unet_state_dict_from_jax(v if name == "unet" else _sub(v, "G"))
        if name == "unet":
            return materialise(ParsingUNet, sd)
        return materialise(FaceParsingLoss, {f"G.{k}": t for k, t in sd.items()})
    return materialise(lambda: LPIPS(name), lpips_state_dict_from_jax(v["params"], name))


# -------------------------------------------------------------- criteria


@pytest.fixture(scope="module")
def criteria_want(nets):
    """The JAX criteria's outputs on the test's inputs, all six from one
    jitted program (eagerly, each op of each trunk compiles alone)."""

    @jax.jit
    def run(nets, y_hat, y, x112):
        unet = nets["unet"]
        return {
            "irse50": JIRSE50().apply(_sub(nets["id"], "facenet"), x112),
            "unet": [JUNet().apply(unet, y)] + JUNet().apply(unet, y, extract_feats_only=True),
            "alex": [JLPIPS("alex").apply(nets["alex"], y_hat, y)],
            "vgg": [JLPIPS("vgg").apply(nets["vgg"], y_hat, y)],
            "id": list(JIDLoss().apply(nets["id"], y_hat, y)),
            "parsing": list(JFaceParsingLoss().apply(nets["parsing"], y_hat, y)),
        }

    return jax.tree_util.tree_map(
        np.asarray, run(nets, _img(5), _img(6), _img(7, (1, 3, 112, 112))))


@pytest.mark.parametrize("name", ["irse50", "alex", "vgg", "unet", "id", "parsing"])
def test_criterion_matches_jax(nets, criteria_want, name):
    y_hat, y = _img(5), _img(6)
    t = torch.from_numpy
    want = criteria_want[name]
    if name == "irse50":
        got = _port(name, nets["id"])(t(_img(7, (1, 3, 112, 112))))
    elif name == "unet":
        model = _port(name, nets["unet"])
        got = [model(t(y))] + model(t(y), extract_feats_only=True)
    elif name in ("alex", "vgg"):
        got = [_port(name, nets[name])(t(y_hat), t(y))]
    else:
        got = _port(name, nets[name])(t(y_hat), t(y))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        assert g.shape == np.shape(w) and np.isfinite(g).all()
        assert rel_err(g, w) < TOL, (name, rel_err(g, w))


@pytest.mark.parametrize("name", ["irse50", "unet", "alex", "vgg"])
def test_converters_round_trip_through_the_jax_package(nets, name):
    """port state_dict -> the JAX package's converter -> the same arrays."""
    if name == "irse50":
        v = _sub(nets["id"], "facenet")
        back = tc.split_batch_stats(tc.convert_irse50(irse50_state_dict_from_jax(v)))
        want = (v["params"], v["batch_stats"])
    elif name == "unet":
        v = nets["unet"]
        back = tc.convert_unet(unet_state_dict_from_jax(v))
        want = (v["params"], v["batch_stats"])
    else:
        p = nets[name]["params"]
        sd = lpips_state_dict_from_jax(p, name)
        conv = tc.convert_alexnet_features if name == "alex" else tc.convert_vgg16_features
        back = (conv({f"features.{k[4:]}": t for k, t in sd.items() if k.startswith("net.")}),
                tc.convert_lpips_lin({k[4:]: t for k, t in sd.items() if k.startswith("lin.")}))
        want = (p["net"], {k: t for k, t in p.items() if k.startswith("lin_")})
    for b, w in zip(back, want):
        fb, fw = dict(_flat(b)), dict(_flat(w))
        if name == "irse50" and ("output_bn1d", "weight") in fb:
            # the reference's embedding BatchNorm1d is affine; the JAX module
            # has no affine part, so the port gives it the identity
            np.testing.assert_array_equal(fb.pop(("output_bn1d", "weight")), 1.0)
            np.testing.assert_array_equal(fb.pop(("output_bn1d", "bias")), 0.0)
        assert fb.keys() == fw.keys()
        for k in fw:
            np.testing.assert_array_equal(np.asarray(fb[k]), np.asarray(fw[k]))


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("build,fixture", [
    (IRSE50Backbone, "ir_se50"), (ParsingUNet, "parsing_unet"),
    (AlexNetFeatures, "alexnet_features"), (VGG16Features, "vgg16_features"),
])
def test_state_dict_keys_are_the_reference(build, fixture):
    with torch.device("meta"):
        sd = build().state_dict()
    want = json.loads((KEYMAPS / f"{fixture}.json").read_text())
    assert {k: list(t.shape) for k, t in sd.items()} == want


# ------------------------------------------------------ loss and gradient


def _optim_opts(tmp, **kw):
    base = dict(num_seg_cls=12, start_from_latent_avg=True, encoder_size=S,
                dataset_root=str(tmp / "no_data"), ds_frac=1.0, lr=0.01,
                opt_name="adam", W_steps=3, optimize_noise=False, bf16=False,
                save_intermediate=False, save_interval=50,
                output_dir=str(tmp / "out"), lpips_lambda=0.8, id_lambda=0.1,
                id_loss_multiscale=True, face_parsing_lambda=0.1, l2_lambda=1.0,
                checkpoint_path=None, ir_se50_path=None,
                face_parsing_model_path=None, **CFG)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def shared(nets, tmp_path_factory):
    """Net3 and the criteria's weights as reference-format files."""
    jnet = JNet3(channels_last=True, encoder_size=S, **CFG)
    key = jax.random.PRNGKey(0)
    v = numpy_variables(jax.eval_shape(lambda: jnet.init(
        {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)),
        jnp.zeros((1, 12, S, S)), latent_avg=jnp.zeros((10, 512)),
        randomize_noise=False)), seed=21)
    la = (0.1 * np.random.RandomState(22).randn(10, 512)).astype(np.float32)
    d = tmp_path_factory.mktemp("ckpts")
    files = dict(checkpoint_path=str(d / "net3.pt"), ir_se50_path=str(d / "ir_se50.pth"),
                 face_parsing_model_path=str(d / "model.pth"))
    torch.save({"state_dict": net3_state_dict_from_jax(v),
                "latent_avg": torch.from_numpy(la)}, files["checkpoint_path"])
    torch.save(irse50_state_dict_from_jax(_sub(nets["id"], "facenet")),
               files["ir_se50_path"])
    torch.save(unet_state_dict_from_jax(nets["unet"]),
               files["face_parsing_model_path"])
    return dict(jnet=jnet, v=v, la=la, files=files)


def test_loss_and_style_gradient_match_jax(nets, shared, tmp_path):
    jnet, v, la = shared["jnet"], shared["v"], shared["la"]
    img, label, _ = jds.SyntheticFaceDataset(size=S)[2]
    img = img[None]
    onehot = jds.label_map_to_onehot(label[None], 12)
    sv = np.random.RandomState(23).rand(1, 12, 1280).astype(np.float32)
    jid, jpar, jlp = JIDLoss(), JFaceParsingLoss(), JLPIPS("alex")

    def j_loss(sv, v, la, img, onehot, nets):
        codes = jnet.apply(v, sv, la, method=JNet3.cal_style_codes)
        recon, _, _ = jnet.apply(v, jnp.zeros((1, 512, 32, 32)), codes, onehot,
                                 method=JNet3.gen_img, randomize_noise=False)
        loss = jid.apply(nets["id"], recon, img)[0] * 0.1
        loss = loss + jnp.mean(jnp.square(recon - img)) * 1.0
        lp = 0.0
        for i in range(3):
            s = max(S // 2 ** i, 32)
            lp = lp + jlp.apply(nets["alex"], j_pool(recon, (s, s)), j_pool(img, (s, s)))
        loss = loss + lp * 0.8
        return loss + jpar.apply(nets["parsing"], recon, img)[0] * 0.1

    # everything an argument: XLA would fold the target's features,
    # computed from constants, on the host at compile time (slowly)
    want, want_g = jax.jit(jax.value_and_grad(j_loss))(sv, v, la, img, onehot, nets)

    opt = Optimizer(_optim_opts(tmp_path, **shared["files"]), device="cpu")
    opt.lpips.load_state_dict(lpips_state_dict_from_jax(nets["alex"]["params"]))
    sv_t = torch.from_numpy(sv).requires_grad_(True)
    recon = opt.gen_from_sv(sv_t, torch.from_numpy(onehot))
    got, aux = opt.calc_loss(torch.from_numpy(img), recon)
    assert set(aux) == {"loss", "loss_id", "loss_l2", "loss_lpips", "loss_face_parsing"}
    (got_g,) = torch.autograd.grad(got, sv_t)
    assert rel_err(got.item(), float(want)) < TOL
    assert np.abs(np.asarray(want_g)).max() > 0
    assert rel_err(got_g.numpy(), want_g) < TOL, rel_err(got_g.numpy(), want_g)


@pytest.mark.parametrize("name", ["sgd", "sgdm", "adam", "adamax"])
def test_optimizers_follow_optax(name):
    rng = np.random.RandomState(3)
    a = rng.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
    b = rng.randn(4, 6).astype(np.float32)
    x0 = rng.randn(4, 6).astype(np.float32)
    tx = make_optimizer(name, 0.05)
    xj, state = jnp.asarray(x0), None
    state = tx.init(xj)
    xt = torch.from_numpy(x0.copy())
    rule = OptaxRule(name, 0.05, [xt])
    for _ in range(10):
        upd, state = tx.update(jnp.asarray(a) * (xj - b), state, xj)
        xj = optax.apply_updates(xj, upd)
        xt.grad = torch.from_numpy(a) * (xt - torch.from_numpy(b))
        rule.step()
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-6 * np.abs(np.asarray(xj)).max()
    assert np.abs(xt.numpy() - x0).max() > 1e-3  # it moved


# ------------------------------------------------------------- the path


@pytest.mark.parametrize("bf16", [False, True])
def test_invertion_runs_on_the_cpu(tmp_path, bf16):
    """3 steps with the noise maps refined too and every step saved: finite
    losses, f32 style vectors (and optimizer moments) under bf16, and the
    files the JAX package writes."""
    opts = _optim_opts(tmp_path, bf16=bf16, optimize_noise=True,
                       save_intermediate=True, save_interval=1)
    opt = Optimizer(opts, device="cpu")
    assert next(opt.net.parameters()).dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert next(opt.id_loss.parameters()).dtype == next(opt.net.parameters()).dtype
    sv, recon, losses = opt.invertion(4)
    assert sv.dtype == torch.float32 and sv.shape == (1, 12, 1280)
    assert recon.dtype == torch.float32 and recon.shape == (1, 3, S, S)
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    names = sorted(p.name for p in (tmp_path / "out" / "sample_4").iterdir())
    assert names == ["sample_4_0001.npy", "sample_4_0001.png", "sample_4_0002.npy",
                     "sample_4_0002.png", "sample_4_0003.npy", "sample_4_0003.png",
                     "sample_4_0003_noise.npz", "sample_4_gt.png", "sample_4_recon.png"]
    with np.load(tmp_path / "out" / "sample_4" / "sample_4_0003_noise.npz") as z:
        assert len(z.files) == opt.net.G.num_layers
        assert all(z[k].dtype == np.float32 for k in z.files)


def test_cli_runs_on_the_cpu_and_needs_a_card_unless_asked(tmp_path, monkeypatch):
    out = tmp_path / "out"
    opts = cli.OptimOptions().parse([
        "--device", "cpu", "--W_steps", "2", "--output_dir", str(out),
        "--dataset_root", str(tmp_path / "none"), "--checkpoint_path", "",
        "--out_size", str(S), "--remaining_layer_idx", "7", "--n_styles", "10"])
    opts.encoder_size = S  # the test's reduced encoder (256 in use)
    sv, _, losses = cli.run(opts)
    assert np.isfinite(losses).all() and len(losses) == 2
    assert (out / "sample_123" / "sample_123_0002.png").exists()
    with pytest.raises(SystemExit):  # a JAX flag that nothing reads
        cli.main(["--num_layers", "18", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--out_size", "64", "--checkpoint_path", ""])


def test_datasets_match_the_jax_package(tmp_path):
    from PIL import Image

    for idx in (0, 5):
        for a, b in zip(tds.SyntheticFaceDataset(size=48)[idx][:2],
                        jds.SyntheticFaceDataset(size=48)[idx][:2]):
            np.testing.assert_array_equal(a, b)
    lab = np.random.RandomState(4).randint(0, 12, (2, 1, 8, 8))
    np.testing.assert_array_equal(tds.label_map_to_onehot(lab, 12),
                                  jds.label_map_to_onehot(lab, 12))
    rng = np.random.RandomState(5)
    for sub in ("CelebA-HQ-img", "CelebA-HQ-mask"):
        (tmp_path / sub).mkdir()
    Image.fromarray(rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(
        tmp_path / "CelebA-HQ-img" / "28000.jpg")
    Image.fromarray(rng.randint(0, 19, (16, 16)).astype(np.uint8)).save(
        tmp_path / "CelebA-HQ-mask" / "28000.png")
    got = tds.CelebAHQDataset(str(tmp_path), mode="test")
    want = jds.CelebAHQDataset(str(tmp_path), mode="test")
    assert len(got) == len(want) == 2000
    for a, b in zip(got[0][:2], want[0][:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
