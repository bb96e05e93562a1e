"""The port's training modules against the JAX package, on the CPU in f32:

- ``ConvLayer`` (plain, downsampling, the bias-free skip, and the skip
  with identity weights against ``downsample2``),
  ``ResBlock`` and the ``Discriminator``'s logits (minibatch groups of 2
  and 4) against the JAX modules at shared numpy weights: 1e-4 relative
  max; D's keys are the reference's, and its converter round-trips through
  the JAX package's;
- the R1 penalty and its gradient with respect to every D weight (a double
  backward) against the JAX ``d_r1_loss`` under ``jax.grad``: 1e-4
  relative max per tensor;
- ``adv_g_loss``, ``adv_d_loss``, ``w_norm_loss`` (value and gradient),
  ``StyleLoss`` with a region mask, ``g_path_regularize`` with the noise
  passed in: 1e-4 relative;
- ``Ranger`` after 1, 6 (the Lookahead sync; RAdam's variance branch
  starts at step 6) and 7 steps against the optax chain
  ``e4s_tpu.training.ranger.ranger``, and Adam with the x0.1-at-100k
  schedule across the boundary against ``optax.adam``: 1e-6 of the largest
  parameter;
- the set of trainable Net3 tensors against the JAX ``trainable_mask`` at
  K = 13, at K = 17 and without ``train_G``;
- the ``DataLoader``'s shuffled order and shards, the mask remaps, the
  FFHQ dataset and ``aggregate_loss_dict`` against the JAX package's;
- the Generator on the fast masked conv against the 12-conv region loop
  (``masked_modulated_conv2d_naive``): the face and the gradients of every
  conv weight, 1e-4 relative.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_helpers import numpy_variables, rel_err, torch_threads

from e4s_tpu.criteria import StyleLoss as JStyleLoss
from e4s_tpu.criteria import adv_loss as jadv
from e4s_tpu.criteria.w_norm import w_norm_loss as j_w_norm
from e4s_tpu.datasets import dataset as jds
from e4s_tpu.models.layers import ConvLayer as JConvLayer
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.models.stylegan2 import Discriminator as JDiscriminator
from e4s_tpu.models.stylegan2 import ResBlock as JResBlock
from e4s_tpu.ops.upfirdn2d import downsample2 as j_downsample2
from e4s_tpu.training.coach import trainable_mask
from e4s_tpu.training.ranger import ranger as j_ranger
from e4s_tpu.utils import img_utils as jimg
from e4s_tpu.utils import torch_convert as tc

from e4s_tpu_torch.convert import (
    _conv_layer,
    discriminator_state_dict_from_jax,
    features_state_dict_from_jax,
    net3_state_dict_from_jax,
)
from e4s_tpu_torch.criteria import adv_loss
from e4s_tpu_torch.criteria.style_loss import StyleLoss
from e4s_tpu_torch.criteria.w_norm import w_norm_loss
from e4s_tpu_torch.datasets import dataset as tds
from e4s_tpu_torch.models import stylegan2 as tsg
from e4s_tpu_torch.models.layers import ConvLayer
from e4s_tpu_torch.models.net3 import Net3
from e4s_tpu_torch.models.stylegan2 import Discriminator, Generator, ResBlock
from e4s_tpu_torch.ops import modconv
from e4s_tpu_torch.pipelines.model_io import materialise
from e4s_tpu_torch.pipelines.optimization import OptaxRule
from e4s_tpu_torch.training.coach import trainable
from e4s_tpu_torch.training.ranger import Ranger, step_decay
from e4s_tpu_torch.utils import img_utils, label_maps

KEYMAPS = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_keymaps"
TOL = 1e-4
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _d_variables(module, x, seed):
    """Seeded numpy params in the module's ``eval_shape`` shapes: weights
    N(0, 1) (the equalised-lr layers scale them), biases 0.1 N(0, 1)."""
    shapes = jax.eval_shape(lambda: module.init(KEY, x))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: ((0.1 if p[-1].key == "bias" else 1.0)
                      * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ----------------------------------------------------- D and its layers

def _layer_case(name):
    """(JAX module, port module from the same weights, input)."""
    if name == "conv":
        jm, tm, x = JConvLayer(24, 3), ConvLayer(16, 24, 3), _x((2, 16, 8, 8))
    elif name == "conv_down":
        jm = JConvLayer(24, 3, downsample=True)
        tm, x = ConvLayer(16, 24, 3, downsample=True), _x((2, 16, 8, 8))
    elif name == "skip":
        jm = JConvLayer(24, 1, downsample=True, activate=False, use_bias=False)
        tm = ConvLayer(16, 24, 1, downsample=True, activate=False, bias=False)
        x = _x((2, 16, 8, 8))
    elif name == "resblock":
        jm, tm, x = JResBlock(16, 24), ResBlock(16, 24), _x((2, 16, 8, 8))
    else:  # "d16_b2", "d32_b4": size and batch (minibatch groups of 2, 4)
        size, b = int(name[1:3]), int(name[-1])
        jm, tm = JDiscriminator(size=size), Discriminator(size)
        x = np.random.RandomState(2).uniform(-1, 1, (b, 3, size, size)).astype(np.float32)
    p = _d_variables(jm, x, seed=3)
    if isinstance(tm, Discriminator):
        sd = discriminator_state_dict_from_jax(p)
    elif isinstance(tm, ResBlock):
        sd = {}
        for k, down in (("conv1", False), ("conv2", True), ("skip", True)):
            _conv_layer(p[k], sd, k, down)
    else:
        sd = {}
        _conv_layer(p, sd, "m", name != "conv")
        sd = {k[2:]: v for k, v in sd.items()}
    tm.load_state_dict(sd)
    return jm, p, tm.requires_grad_(False), x


@pytest.mark.parametrize("name", ["downsample2", "conv", "conv_down", "skip",
                                  "resblock", "d16_b2", "d32_b4"])
def test_discriminator_layers_match_jax(name):
    if name == "downsample2":
        # D's downsample (the skip's blur then 1x1 stride-2 conv) with
        # identity weights is the JAX package's ``downsample2``
        x = _x((2, 5, 12, 12))
        want = j_downsample2(x)
        tm = ConvLayer(5, 5, 1, downsample=True, activate=False, bias=False)
        with torch.no_grad():
            tm[1].weight.copy_(torch.eye(5)[:, :, None, None] / tm[1].scale)
        got = tm.requires_grad_(False)(torch.from_numpy(x))
    else:
        jm, p, tm, x = _layer_case(name)
        want = jm.apply({"params": p}, x)
        got = tm(torch.from_numpy(x))
    got = got.numpy()
    assert got.shape == np.shape(want) and np.isfinite(got).all()
    assert rel_err(got, want) < TOL, rel_err(got, want)


def test_discriminator_keys_and_converter_are_the_reference():
    with torch.device("meta"):
        sd = Discriminator(1024).state_dict()
    want = json.loads((KEYMAPS / "stylegan2_discriminator.json").read_text())
    assert {k: list(t.shape) for k, t in sd.items()} == want
    _, p, _, _ = _layer_case("d16_b2")
    back = tc.convert_discriminator(discriminator_state_dict_from_jax(p))
    flat_b, flat_p = dict(_flat(back)), dict(_flat(p))
    assert flat_b.keys() == flat_p.keys()
    for k in flat_p:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), flat_p[k])


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_r1_penalty_and_its_gradient_match_jax():
    jm, p, tm, x = _layer_case("d16_b2")

    def j_r1(params):
        return jadv.d_r1_loss(lambda q, img: jm.apply({"params": q}, img), params, x)

    want, want_g = jax.value_and_grad(j_r1)(p)
    tm.requires_grad_(True)
    img = torch.from_numpy(x).requires_grad_(True)
    got = adv_loss.d_r1_loss(tm(img), img)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(got, list(tm.parameters()), allow_unused=True,
                                materialize_grads=True)
    assert float(want) > 0 and rel_err(got.item(), float(want)) < TOL
    want_sd = discriminator_state_dict_from_jax(want_g)
    top = max(np.abs(np.asarray(v)).max() for v in want_sd.values())
    for n, g in zip(names, grads):
        w = want_sd[n].numpy()
        if np.abs(w).max() > 1e-3 * top:
            assert rel_err(g.numpy(), w) < TOL, (n, rel_err(g.numpy(), w))
        else:  # no path from the penalty to it (the last layer's bias)
            assert np.abs(g.numpy() - w).max() <= 1e-6 * top, n


# ------------------------------------------------------------- losses

def test_adversarial_and_w_norm_losses_match_jax():
    real, fake = _x((4, 1), 4), _x((4, 1), 5)
    t = torch.from_numpy
    assert rel_err(adv_loss.adv_g_loss(t(fake)).item(), jadv.adv_g_loss(fake)) < TOL
    assert rel_err(adv_loss.adv_d_loss(t(real), t(fake)).item(),
                   jadv.adv_d_loss(real, fake)) < TOL
    lat, la = _x((2, 12, 6, 512), 6), _x((6, 512), 7)
    want, want_g = jax.value_and_grad(j_w_norm)(lat, la)
    lat_t = t(lat).requires_grad_(True)
    got = w_norm_loss(lat_t, t(la))
    (got_g,) = torch.autograd.grad(got, lat_t)
    assert rel_err(got.item(), float(want)) < TOL
    assert rel_err(got_g.numpy(), want_g) < TOL
    assert rel_err(w_norm_loss(t(lat), None, False).item(),
                   float(j_w_norm(lat, None, False))) < TOL


def test_style_loss_with_a_region_mask_matches_jax():
    x, x_hat = (np.random.RandomState(s).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
                for s in (8, 9))
    label = np.random.RandomState(10).randint(0, 6, (2, 1, 32, 32))
    hair = (label == 3).astype(np.float32)
    jm = JStyleLoss()
    shapes = jax.eval_shape(lambda: jm.init(KEY, x, x_hat))
    v = numpy_variables(shapes, 11)
    rng = np.random.default_rng(12)
    for layer in v["params"]["vgg16_act"].values():
        w = layer["weight"]
        layer["weight"] = (rng.standard_normal(w.shape) / np.sqrt(np.prod(w.shape[1:]))
                           ).astype(np.float32)
    want = jm.apply(v, x, x_hat, mask_x=hair, mask_x_hat=hair)
    model = StyleLoss()
    model.vgg16_act.load_state_dict(
        features_state_dict_from_jax(v["params"]["vgg16_act"], "vgg"))
    t = torch.from_numpy
    got = model(t(x), t(x_hat), mask_x=t(hair), mask_x_hat=t(hair))
    assert float(want) > 0 and rel_err(got.item(), float(want)) < TOL


def test_path_length_regulariser_matches_jax():
    lat = _x((2, 6, 8), 13)
    mix = _x((8, 3 * 4 * 4), 14)
    noise = np.array(jax.random.normal(KEY, (2, 3, 4, 4)))

    def j_img(latent):
        return jnp.tanh(jnp.mean(latent, 1) @ mix).reshape(2, 3, 4, 4)

    def grad_fn(n):
        return jax.grad(lambda lt: jnp.sum(j_img(lt) * n))(lat)

    want = jadv.g_path_regularize(j_img(lat), grad_fn, 0.5, KEY)
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    img = torch.tanh(lat_t.mean(1) @ torch.from_numpy(mix)).reshape(2, 3, 4, 4)
    got = adv_loss.g_path_regularize(img, lat_t, 0.5, noise=torch.from_numpy(noise))
    for g, w in zip(got, want):
        assert rel_err(g.detach().numpy(), w) < TOL


# ---------------------------------------------------------- optimizers

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3, 3, 3).astype(np.float32),
            "b": rng.randn(4).astype(np.float32),
            "m": rng.randn(5, 6).astype(np.float32)}


@pytest.mark.parametrize("steps", [1, 6, 7])
def test_ranger_follows_the_optax_chain(steps):
    x0, a, b = _tree(1), _tree(2), _tree(3)
    tx = j_ranger(0.05)
    xj = jax.tree_util.tree_map(jnp.asarray, x0)
    state = tx.init(xj)
    xt = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in x0.items()}
    opt = Ranger(list(xt.values()), 0.05)
    for _ in range(steps):
        g = {k: np.abs(a[k]) * (np.asarray(xj[k]) - b[k]) for k in x0}
        upd, state = tx.update(g, state, xj)
        xj = optax.apply_updates(xj, upd)
        for k, p in xt.items():
            p.grad = torch.from_numpy(np.abs(a[k])) * (p.detach() - torch.from_numpy(b[k]))
        opt.step()
    top = max(np.abs(np.asarray(v)).max() for v in xj.values())
    for k in x0:
        assert np.abs(xt[k].detach().numpy() - np.asarray(xj[k])).max() <= 1e-6 * top, k
        assert np.abs(xt[k].detach().numpy() - x0[k]).max() > 1e-3  # it moved


def test_adam_schedule_crosses_100k_as_optax():
    x0, a, b = _tree(4), _tree(5), _tree(6)
    tx = optax.adam(optax.piecewise_constant_schedule(0.05, {100_000: 0.1}))
    xj = jax.tree_util.tree_map(jnp.asarray, x0)
    adam_state, sched_state = tx.init(xj)
    count = jnp.asarray(99_998, jnp.int32)
    state = (adam_state._replace(count=count), sched_state._replace(count=count))
    xt = {k: torch.from_numpy(v.copy()) for k, v in x0.items()}
    rule = OptaxRule("adam", step_decay(0.05), list(xt.values()))
    rule.count = 99_998
    moves = []
    for _ in range(4):  # updates 99 998, 99 999 at lr; 100 000, 100 001 at lr/10
        g = {k: np.abs(a[k]) * (np.asarray(xj[k]) - b[k]) for k in x0}
        upd, state = tx.update(g, state, xj)
        moves.append(float(np.abs(np.asarray(upd["m"])).max()))
        xj = optax.apply_updates(xj, upd)
        for k in x0:
            xt[k].grad = torch.from_numpy(np.abs(a[k])) * (xt[k] - torch.from_numpy(b[k]))
        rule.step()
    top = max(np.abs(np.asarray(v)).max() for v in xj.values())
    for k in x0:
        assert np.abs(xt[k].numpy() - np.asarray(xj[k])).max() <= 1e-6 * top, k
    assert max(moves[2:]) < 0.2 * min(moves[:2])  # the step shrank at 100k


# ------------------------------------------------------- trainable set

@pytest.fixture(scope="module")
def net3_names():
    """{K: (JAX leaf paths of Net3 at 1024^2, the port's name of each)},
    from leaves that each hold their own index (shapes do not matter to
    the converter)."""
    out = {}
    for K in (13, 17):
        jnet = JNet3(remaining_layer_idx=K, n_styles=18, channels_last=True)
        shapes = jax.eval_shape(lambda: jnet.init(
            {"params": KEY, "noise": KEY}, jnp.zeros((1, 3, 1024, 1024)),
            jnp.zeros((1, 12, 1024, 1024)), latent_avg=jnp.zeros((18, 512)),
            randomize_noise=False))
        leaves, treedef = jax.tree_util.tree_flatten(shapes["params"])
        idx = jax.tree_util.tree_unflatten(
            treedef, [np.full((1,), i, np.float32) for i in range(len(leaves))])
        sd = net3_state_dict_from_jax({"params": idx, "noises": {}})
        with torch.device("meta"):
            names = [n for n, _ in Net3(remaining_layer_idx=K).named_parameters()]
        out[K] = (shapes["params"], {n: int(sd[n].reshape(-1)[0]) for n in names})
    return out


@pytest.mark.parametrize("K,train_G", [(13, True), (17, True), (13, False)])
def test_trainable_set_matches_the_jax_mask(net3_names, K, train_G):
    params, index = net3_names[K]
    mask = jax.tree_util.tree_leaves(
        trainable_mask(params, train_G=train_G, remaining_layer_idx=K))
    assert len(index) == len(mask)
    got = {n: trainable(n, train_G=train_G, remaining_layer_idx=K) for n in index}
    want = {n: bool(mask[i]) for n, i in index.items()}
    assert got == want
    assert 0 < sum(got.values()) < len(got)


# ------------------------------------------------------------- datasets

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((3, 2, 2), i, np.float32),
                np.full((1, 2, 2), i % 12, np.int32), -1)


@pytest.mark.parametrize("shuffle,shards,batch", [(True, 1, 3), (True, 3, 2),
                                                  (False, 2, 4)])
def test_data_loader_order_and_shards_match_jax(shuffle, shards, batch):
    for shard in range(shards):
        kw = dict(batch_size=batch, shuffle=shuffle, seed=7, num_shards=shards,
                  shard_index=shard)
        got_l, want_l = tds.DataLoader(_Items(17), **kw), jds.DataLoader(_Items(17), **kw)
        assert len(got_l) == len(want_l)
        for _ in range(2):  # two epochs
            got, want = list(got_l), list(want_l)
            assert len(got) == len(want) == len(got_l)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_mask_remaps_ffhq_and_loss_averaging_match_jax(tmp_path):
    from PIL import Image

    m = np.random.RandomState(3).randint(0, 19, (9, 9))
    for name in ("ffhq_mask_to_faceparser_mask_detailed", "ffhq_mask_to_faceparser_mask",
                 "celebahq_mask_to_faceparser_mask_detailed",
                 "celebahq_mask_to_faceparser_mask"):
        np.testing.assert_array_equal(getattr(label_maps, name)(m), getattr(jds, name)(m))
    rng = np.random.RandomState(4)
    (tmp_path / "images_1024").mkdir()
    (tmp_path / "BiSeNet_mask").mkdir()
    for n in ("00002.png", "00001.png"):
        Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(
            tmp_path / "images_1024" / n)
        Image.fromarray(rng.randint(0, 19, (8, 8)).astype(np.uint8)).save(
            tmp_path / "BiSeNet_mask" / n)
    (tmp_path / "images_1024" / "ffhq_list.txt").write_text("00002.png\n00001.png\n")
    got, want = tds.FFHQDataset(str(tmp_path)), jds.FFHQDataset(str(tmp_path))
    assert len(got) == len(want) == 2
    for i in range(2):
        for a, b in zip(got[i][:2], want[i][:2]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    dicts = [{"a": 1.0, "b": 2.0}, {"a": 3.0}]
    assert img_utils.aggregate_loss_dict(dicts) == jimg.aggregate_loss_dict(dicts)


# ------------------------------------------------- G: fast against naive

def test_generator_fast_masked_conv_matches_the_region_loop(monkeypatch):
    """The whole Generator (16^2, K = 5, 6 styles) on the fast masked conv
    and on the 12-conv region loop: the face and the gradients of every
    conv weight, the ones training now differentiates."""
    G = materialise(lambda: Generator(16, remaining_layer_idx=5), seed=4)
    G.requires_grad_(True)
    rng = np.random.RandomState(5)
    latent = torch.from_numpy(rng.randn(2, 12, 6, 512).astype(np.float32))
    label = rng.randint(0, 12, (2, 16, 16))
    mask = torch.from_numpy((label[:, None] == np.arange(12)[None, :, None, None])
                            .astype(np.float32))
    convs = [n for n, p in G.named_parameters() if n.endswith("conv.weight")]
    params = dict(G.named_parameters())

    def run():
        img, _, _ = G([latent], None, mask, input_is_latent=True, randomize_noise=False)
        return img, torch.autograd.grad(img.square().mean(), [params[n] for n in convs])

    fast, fast_g = run()

    def naive(x, w, s, m, *, weights=None, **kw):
        return modconv.masked_modulated_conv2d_naive(x, w, s, m, **kw)

    monkeypatch.setattr(tsg, "masked_modulated_conv2d", naive)
    slow, slow_g = run()
    assert rel_err(fast.detach().numpy(), slow.detach().numpy()) < TOL
    for n, a, b in zip(convs, fast_g, slow_g):
        assert np.abs(b.numpy()).max() > 0, n
        assert rel_err(a.numpy(), b.numpy()) < TOL, (n, rel_err(a.numpy(), b.numpy()))


@pytest.mark.parametrize("k,stride,padding,size", [(3, 1, 1, 9), (3, 2, 0, 10),
                                                   (3, 2, 0, 9), (1, 2, 0, 8)])
def test_conv2d_double_backward_matches_f_conv2d(k, stride, padding, size):
    """``ops/conv.py::conv2d`` (the discriminator's conv) against
    ``F.conv2d``: the forward, and the gradients w.r.t. the input, weight
    and bias of a loss made of the first gradients (as R1's is), in f64:
    1e-10 relative."""
    from e4s_tpu_torch.ops.conv import conv2d

    rng = np.random.RandomState(k * 100 + stride * 10 + size)
    x0 = torch.from_numpy(rng.randn(2, 5, size, size))
    w0 = torch.from_numpy(rng.randn(6, 5, k, k))
    b0 = torch.from_numpy(rng.randn(6))
    n = (size + 2 * padding - k) // stride + 1
    r = torch.from_numpy(rng.randn(2, 6, n, n))

    def run(fn):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        out = fn(x, w, b, stride=stride, padding=padding)
        gx, gw = torch.autograd.grad((out * r).tanh().sum(), (x, w), create_graph=True)
        second = torch.autograd.grad(gx.pow(2).sum() + gw.pow(2).sum(), (x, w, b))
        return (out,) + second

    for got, want in zip(run(conv2d), run(F.conv2d)):
        assert rel_err(got.detach().numpy(), want.detach().numpy()) < 1e-10


@pytest.mark.parametrize("pad", [1, 2])
def test_blur_double_backward_matches_upfirdn2d(pad):
    """``ops/conv.py::blur`` against ``upfirdn2d``: the forward and the
    gradient of a loss made of the first gradient, in f64: 1e-10
    relative."""
    from e4s_tpu_torch.ops.conv import blur
    from e4s_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d

    fir = make_kernel((1, 3, 3, 2)).double()  # asymmetric: the flip shows
    rng = np.random.RandomState(pad)
    x0 = torch.from_numpy(rng.randn(2, 5, 9, 9))
    r = torch.from_numpy(rng.randn(2, 5, 6 + 2 * pad, 6 + 2 * pad))

    def run(fn):
        x = x0.clone().requires_grad_(True)
        out = fn(x)
        (gx,) = torch.autograd.grad((out * r).tanh().sum(), x, create_graph=True)
        return out, torch.autograd.grad(gx.pow(2).sum(), x)[0]

    got = run(lambda x: blur(x, fir, pad))
    want = run(lambda x: upfirdn2d(x, fir, pad=(pad, pad)))
    for g, w in zip(got, want):
        assert rel_err(g.detach().numpy(), w.detach().numpy()) < 1e-10
