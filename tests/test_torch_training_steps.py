"""The port's ``Coach`` steps against the JAX package's, on the CPU in f32,
at shared numpy weights: Net3 at 16^2 (K = 5, 6 styles; the JAX package's
small-model knobs: a 32^2 encoder input, one encoder unit per stage, G and
D stages narrowed 8x), D at 16^2, batch 2, Adam, the losses of the JAX package's dry run
(l2, three-scale LPIPS, w-norm, the adversarial G loss; ID and parsing are
held in ``test_torch_inversion.py``), the noise fixed to the generator's
registered maps on both sides. The JAX side is the ``Coach``'s own
``_g_step`` / ``_d_step`` / ``_d_r1_step`` on a ``Coach`` built without
``__init__`` (whose ``init`` compiles are not needed).

- the loss dicts: the same keys, 1e-4 of max(|value|, 1) (D's scores are
  means of logits near 0);
- the updates: Adam's first step is +-lr per element, so the deltas are
  compared by sign, at most 1% of the elements differing (elements whose
  gradient is near 0 may flip), and every frozen tensor unchanged;
- checkpoint -> ``load_checkpoint`` -> the next step bit for bit;
  checkpoint -> ``load_net3`` -> a swap; a bf16 G, D and R1 step on the
  CPU (f32 master weights); the CLI, and its refusal without a card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, torch_threads

from e4s_tpu.datasets import dataset as jds
from e4s_tpu.models.lpips_nets import LPIPS as JLPIPS
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.models.stylegan2 import Discriminator as JDiscriminator
from e4s_tpu.training import coach as jc

from e4s_tpu_torch.cli import train as cli
from e4s_tpu_torch.convert import (
    discriminator_state_dict_from_jax,
    lpips_state_dict_from_jax,
    net3_state_dict_from_jax,
)
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper
from e4s_tpu_torch.training.coach import Coach

S, K, NS = 16, 5, 6
KEY = jax.random.PRNGKey(0)
TOL = 1e-4
SIGN_SHARE = 0.01  # most elements whose update's sign may differ


def _opts(tmp, **kw):
    base = dict(exp_dir=str(tmp), device="cpu", num_seg_cls=12, out_size=S,
                remaining_layer_idx=K, n_styles=NS, encoder_size=32,
                encoder_slim=True, ch_div=8, start_from_latent_avg=True, train_G=True, train_D=True,
                learning_rate=1e-4, optim_name="adam", d_reg_every=2, d_every=1,
                max_steps=1, board_interval=1, image_interval=0,
                val_interval=1000, save_interval=1000, seed=0, bf16=False,
                dataset_name="synthetic", batch_size=2, latent_avg_samples=16,
                lpips_lambda=0.8, id_lambda=0.0, id_loss_multiscale=True,
                face_parsing_lambda=0.0, l2_lambda=1.0, w_norm_lambda=0.01,
                r1_lambda=10.0, g_adv_lambda=0.01, style_lambda=0.0,
                style_loss_norm=1, stylegan_weights=None, checkpoint_path=None,
                ir_se50_path=None, face_parsing_model_path=None,
                tensorboard=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Checkpoints here are hundreds of MB (the LocalMLPs keep their full
    width): delete each test's once it ends."""
    yield
    for f in tmp_path.rglob("*.pt"):
        f.unlink()


def _batch():
    ds = jds.SyntheticFaceDataset(size=S)
    img = np.stack([ds[i][0] for i in (1, 2)])
    label = np.stack([ds[i][1] for i in (1, 2)]).astype(np.int32)
    return img, label, jds.label_map_to_onehot(label, 12)


def _registered_noise(coach):
    G = coach.net.G
    return [getattr(G.noises, f"noise_{i}") for i in range(G.num_layers)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX steps' results and the numpy weights they started from."""
    tmp = tmp_path_factory.mktemp("steps")
    opts = _opts(tmp)
    c = jc.Coach.__new__(jc.Coach)
    c.opts, c.mixed_precision = opts, False
    c.net = JNet3(out_size=S, remaining_layer_idx=K, n_styles=NS,
                  channels_last=True, encoder_size=32, encoder_slim=True, ch_div=8)
    c.D = JDiscriminator(size=S, ch_div=8)
    c.lpips = JLPIPS("alex")
    img, label, onehot = _batch()
    shapes = jax.eval_shape(lambda: c.net.init(
        {"params": KEY, "noise": KEY}, img, onehot, latent_avg=jnp.zeros((NS, 512)),
        randomize_noise=False))
    v = numpy_variables(shapes, seed=31)
    # the EMA starts away from the parameters, so that its update is far
    # above f32 rounding
    ema0 = numpy_variables(shapes, seed=35)["params"]
    dp = numpy_variables(jax.eval_shape(lambda: c.D.init(KEY, img)), seed=32)["params"]
    lv = numpy_variables(jax.eval_shape(lambda: c.lpips.init(KEY, img, img)), seed=33)
    la = (0.1 * np.random.RandomState(34).randn(NS, 512)).astype(np.float32)

    def sched(lr):
        return optax.piecewise_constant_schedule(lr, {100_000: 0.1})

    c.tx, c.tx_d = optax.adam(sched(1e-4)), optax.adam(sched(1e-4 * 2 / 3))
    c.mask_tree = jc.trainable_mask(v["params"], train_G=True, remaining_layer_idx=K)

    def net_forward(params, noises, img, onehot, latent_avg, rng):
        return c.net.apply({"params": params, "noises": noises}, img, onehot,
                           latent_avg=latent_avg, randomize_noise=False,
                           return_latents=True)

    c._net_forward = net_forward
    state = jc.TrainState(
        step=jnp.zeros([], jnp.int32), params=v["params"], noises=v["noises"],
        opt_state=c.tx.init(v["params"]), ema_params=ema0, latent_avg=la,
        params_d=dp, opt_state_d=c.tx_d.init(dp))
    g_state, g_losses = jax.jit(c._g_step)(state, {"lpips": lv}, img, label, onehot, KEY)
    d_state, d_losses = jax.jit(c._d_step)(state, img, onehot, KEY)
    r1_state, r1_losses = jax.jit(c._d_r1_step)(state, img)
    ckpt = tmp / "start.pt"
    torch.save({"state_dict": net3_state_dict_from_jax(v),
                "latent_avg": torch.from_numpy(la),
                "D_state_dict": discriminator_state_dict_from_jax(dp)}, ckpt)
    yield dict(
        v=v, dp=dp, lv=lv, ckpt=str(ckpt), batch=(img, label, onehot),
        ema0=net3_state_dict_from_jax({"params": ema0, "noises": {}}),
        g=(jax.device_get(g_state.params), jax.device_get(g_state.ema_params), g_losses),
        d=(jax.device_get(d_state.params_d), d_losses),
        r1=(jax.device_get(r1_state.params_d), r1_losses))
    ckpt.unlink()


def _port(case, tmp, ckpt=None, **kw):
    """The port's Coach with the case's weights, or resumed from ``ckpt``."""
    with torch_threads(2):
        coach = Coach(_opts(tmp, **kw))
        coach.load_checkpoint(ckpt or case["ckpt"])
        coach.lpips.load_state_dict(lpips_state_dict_from_jax(case["lv"]["params"]))
    return coach


def _tensors(case):
    return tuple(torch.from_numpy(a) for a in case["batch"])


def _assert_losses(got, want):
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= TOL * max(abs(w), 1.0), (k, float(got[k]), w)


def _assert_updates(before, after, want_after, names, min_moved=0.5):
    """Over the tensors ``names``: the signs of the port's and the JAX
    package's updates agree on all but SIGN_SHARE of the elements, and at
    least ``min_moved`` of them moved."""
    differ = total = moved = 0
    for n in names:
        d_got = np.sign(after[n].numpy() - before[n])
        d_want = np.sign(want_after[n] - before[n])
        differ += int((d_got != d_want).sum())
        total += d_got.size
        moved += int((d_want != 0).sum())
    assert moved >= min_moved * total, (moved, total)
    assert differ <= SIGN_SHARE * total, (differ, total)


def _start_ema(coach, case):
    """The port's EMA set to the case's starting EMA; returns it in f64."""
    ema0 = {n: case["ema0"][n] for n in coach.ema}
    for n, e in coach.ema.items():
        e.copy_(ema0[n])
    return {n: e.double().numpy() for n, e in ema0.items()}


def test_g_step_matches_jax(case, tmp_path):
    coach = _port(case, tmp_path)
    ema0 = _start_ema(coach, case)
    before = {n: p.detach().numpy().copy() for n, p in coach.net.named_parameters()}
    img, label, onehot = _tensors(case)
    with torch_threads(2):
        losses = coach._g_step(img, label, onehot, noise=_registered_noise(coach))
    want_params, want_ema, want_losses = case["g"]
    _assert_losses(losses, want_losses)
    want = {k: t.numpy() for k, t in net3_state_dict_from_jax(
        {"params": want_params, "noises": {}}).items()}
    after = dict(coach.net.named_parameters())
    train = [n for n, p in after.items() if p.requires_grad]
    _assert_updates(before, {n: p.detach() for n, p in after.items()}, want, train)
    for n, p in after.items():
        if not p.requires_grad:
            np.testing.assert_array_equal(p.detach().numpy(), before[n])
            np.testing.assert_array_equal(want[n], before[n])
    # the EMA's move from its start against the JAX package's: within 1e-3
    # of it, plus 4 f32 ulps of the start and (1 - ACCUM) times the two
    # packages' parameters' difference (their updates' signs may differ)
    want_ema = net3_state_dict_from_jax({"params": want_ema, "noises": {}})
    moved = total = 0
    for n, e in coach.ema.items():
        got_d = e.double().numpy() - ema0[n]
        want_d = want_ema[n].double().numpy() - ema0[n]
        ulps = 4 * np.finfo(np.float32).eps * np.abs(ema0[n])
        dp = (1 - jc.ACCUM) * np.abs(after[n].detach().double().numpy() - want[n])
        assert (np.abs(got_d - want_d) <= 1e-3 * np.abs(want_d) + ulps + dp).all(), n
        moved += int((np.abs(want_d) > 10 * ulps).sum())
        total += want_d.size
    assert moved >= 0.5 * total, (moved, total)  # far above rounding


def test_ema_follows_the_parameters_after_the_step(case, tmp_path):
    """At lr 0.1 (each Adam step +-0.1) the EMA is ACCUM e + (1 - ACCUM) p
    in f64, with p the parameters after the step and ACCUM the JAX
    package's, within the f32 rounding of each term (eps times their
    sizes); p before the step would be off by (1 - ACCUM) 0.1 = 2.2e-5."""
    coach = _port(case, tmp_path, learning_rate=0.1)
    ema0 = _start_ema(coach, case)
    img, label, onehot = _tensors(case)
    with torch_threads(2):
        coach._g_step(img, label, onehot, noise=_registered_noise(coach))
    after = dict(coach.net.named_parameters())
    for n, e in coach.ema.items():
        p = after[n].detach().double().numpy()
        want = jc.ACCUM * ema0[n] + (1 - jc.ACCUM) * p
        ulps = np.finfo(np.float32).eps * (
            np.abs(ema0[n]) + (1 - jc.ACCUM) * np.abs(p) + np.abs(want))
        assert (np.abs(e.double().numpy() - want) <= ulps).all(), n


@pytest.mark.parametrize("step", ["d", "r1"])
def test_d_and_r1_steps_match_jax(case, tmp_path, step):
    coach = _port(case, tmp_path)
    before = {n: p.detach().numpy().copy() for n, p in coach.D.named_parameters()}
    img, _, onehot = _tensors(case)
    with torch_threads(2):
        if step == "d":
            losses = coach._d_step(img, onehot, noise=_registered_noise(coach))
        else:
            losses = coach._d_r1_step(img)
    want_params, want_losses = case[step]
    _assert_losses(losses, want_losses)
    want = {k: t.numpy() for k, t in discriminator_state_dict_from_jax(want_params).items()}
    after = {n: p.detach() for n, p in coach.D.named_parameters()}
    # at these random weights most of R1's gradient is far below Adam's eps
    # (the update rounds away in f32); D's last layers do move
    _assert_updates(before, after, want, list(after),
                    min_moved=0.5 if step == "d" else 0.02)


def test_checkpoint_resumes_to_the_same_next_step(case, tmp_path):
    """Two Ranger steps with a checkpoint between; a new Coach resumed from
    it takes the same second step, bit for bit (moments, slow weights,
    count, EMA and D)."""
    img, label, onehot = _tensors(case)
    a = _port(case, tmp_path / "a", optim_name="ranger")
    noise = _registered_noise(a)
    with torch_threads(2):
        a._d_step(img, onehot, noise=noise)
        a._g_step(img, label, onehot, noise=noise)
        a.global_step = 3
        a.checkpoint_me({}, is_best=False)
    b = _port(case, tmp_path / "b", optim_name="ranger",
              ckpt=str(tmp_path / "a" / "checkpoints" / "iteration_3.pt"))
    assert b.global_step == 4
    with torch_threads(2):
        got = [c._g_step(img, label, onehot, noise=noise) for c in (a, b)]
        [c._d_step(img, onehot, noise=noise) for c in (a, b)]
    for k in got[0]:
        assert float(got[0][k]) == float(got[1][k]), k
    for m in ("net", "D"):
        for (n, p), q in zip(getattr(a, m).state_dict().items(),
                             getattr(b, m).state_dict().values()):
            assert torch.equal(p, q), (m, n)
    for n in a.ema:
        assert torch.equal(a.ema[n], b.ema[n]), n


def test_a_trained_checkpoint_loads_into_the_swap(case, tmp_path):
    coach = _port(case, tmp_path)
    img, label, onehot = _tensors(case)
    with torch_threads(2):
        coach._g_step(img, label, onehot)
        coach.checkpoint_me({}, is_best=True)
        swapper = FaceSwapper(types.SimpleNamespace(
            num_seg_cls=12, start_from_latent_avg=True, parser_size=64,
            out_size=S, remaining_layer_idx=K, n_styles=NS, encoder_size=32,
            encoder_slim=True, ch_div=8, checkpoint_path=str(tmp_path / "checkpoints" / "best_model.pt")),
            device="cpu")
        for n, p in swapper.net.named_parameters():
            assert torch.equal(p, dict(coach.net.named_parameters())[n]), n
        out = np.asarray(swapper.swap_from_arrays((img[:1].numpy() + 1) / 2,
                                                  (img[1:].numpy() + 1) / 2))
    assert out.shape == (S, S, 3) and out.dtype == np.uint8


def test_stylegan2_bootstrap_loads_g_ema_and_latent_avg(tmp_path):
    """A rosinality-format file (``g_ema``, ``d``, ``latent_avg``) that the
    test writes: G takes ``g_ema`` by ``load_state_dict``, latent_avg is the
    file's tiled over the styles, D keeps its weights below 1024^2 (as the
    JAX package's bootstrap)."""
    from e4s_tpu_torch.models.stylegan2 import Discriminator, Generator
    from e4s_tpu_torch.pipelines.model_io import materialise

    G = materialise(lambda: Generator(S, remaining_layer_idx=K, ch_div=8), seed=41)
    D = materialise(lambda: Discriminator(S, ch_div=8), seed=42)
    la = torch.from_numpy(np.random.RandomState(43).randn(1, 512).astype(np.float32))
    path = tmp_path / "stylegan2.pt"
    torch.save({"g_ema": G.state_dict(), "d": D.state_dict(), "latent_avg": la}, path)
    with torch_threads(2):
        coach = Coach(_opts(tmp_path, stylegan_weights=str(path)))
    for n, t in G.state_dict().items():
        assert torch.equal(coach.net.G.state_dict()[n], t), n
    assert torch.equal(coach.latent_avg, la.expand(NS, -1))
    assert not torch.equal(coach.D.convs[0][0].weight, D.convs[0][0].weight)


def test_bf16_steps_keep_f32_master_weights(case, tmp_path):
    coach = _port(case, tmp_path, bf16=True)
    assert next(coach.lpips.parameters()).dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in coach.net.named_parameters()}
    img, label, onehot = _tensors(case)
    with torch_threads(2):
        d = coach._d_step(img, onehot)
        d.update(coach._d_r1_step(img))
        g = coach._g_step(img, label, onehot)
    assert all(np.isfinite(float(v)) for v in {**d, **g}.values())
    for n, p in coach.net.named_parameters():
        assert p.dtype == torch.float32 and coach.ema[n].dtype == torch.float32
    moved = [n for n, p in coach.net.named_parameters()
             if p.requires_grad and not torch.equal(p, before[n])]
    # the LocalMLPs of the regions absent from both masks take no gradient
    with_grad = [n for n, p in coach.net.named_parameters()
                 if p.grad is not None and p.grad.abs().max() > 0]
    assert moved == with_grad
    assert len(moved) > sum(p.requires_grad for p in coach.net.parameters()) // 2


def test_cli_trains_on_the_cpu_and_needs_a_card_unless_asked(tmp_path, monkeypatch):
    opts = cli.TrainOptions().parse([
        "--device", "cpu", "--exp_dir", str(tmp_path), "--dataset_name", "synthetic",
        "--out_size", str(S), "--remaining_layer_idx", str(K), "--n_styles", str(NS),
        "--max_steps", "1", "--d_every", "1", "--d_reg_every", "1",
        "--id_lambda", "0", "--face_parsing_lambda", "0", "--latent_avg_samples", "16",
        "--image_interval", "0", "--board_interval", "1", "--optim_name", "ranger"])
    # the test's small model (256, full depth and width in use)
    opts.encoder_size, opts.encoder_slim, opts.ch_div = 32, True, 8
    with torch_threads(2):
        coach = cli.run(opts)
    assert coach.global_step == 2
    assert (tmp_path / "opt.json").exists()
    assert sorted(p.name for p in (tmp_path / "checkpoints").glob("*.pt")) == [
        "best_model.pt", "iteration_1.pt"]
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3  # train steps 0 and 1, the test at step 1
    with pytest.raises(SystemExit):  # a JAX flag that the port does not read
        cli.main(["--channels_last", "false", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--out_size", str(S), "--exp_dir", str(tmp_path / "gpu")])
