"""bf16 in the port against the JAX package's ``--bf16``, on the CPU.

- The masked-conv kernel's bf16 plain version (the CPU path of the bf16
  kernel) against the JAX Pallas kernel in interpret mode and against the
  JAX XLA path on the same bf16 inputs (16^2, Ci = Co = 128): within one
  bf16 ulp of max |want| (both accumulate in f32 in another order and round
  once).
- The bf16 polyphase composite against the JAX ``_composite_up_kernel``:
  bit for bit, or one bf16 ulp where the f32 sums of the two round apart.
- The bf16 kernel's weight tiles, read as the kernel indexes them; its
  sum written out on the CPU with that indexing (chunks, tap rows, k16
  slices, the channel permutation) against the plain version; the
  wrapper's refusal of mixed dtypes.
- Net3 in bf16 at 128^2 (K = 9) against the JAX package in bf16 and against
  the port in f32, at the JAX package's own bf16 gate
  (``tests/test_pipelines.py::test_bf16_quality_gate``): PSNR >= 40 dB and
  relative RMSE <= 3%.
- The bf16 fused swap (BiSeNet in f32, Net3 in bf16, 64^2) against the JAX
  bf16 program: >= 40 dB PSNR on uint8.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import numpy_variables, psnr_u8, torch_threads

from e4s_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s_tpu.models.net3 import Net3 as JNet3
from e4s_tpu.ops import modconv as jmc
from e4s_tpu.ops.pallas.modconv_tpu import patch_mod_conv3_nhwc as j_pallas
from e4s_tpu.ops.upfirdn2d import make_kernel as j_make_kernel
from e4s_tpu.pipelines.model_io import cast_pytree_bf16
from e4s_tpu.pipelines.swap_core import make_swap_e2e as j_make_swap_e2e

from e4s_tpu_torch.convert import bisenet_state_dict_from_jax, net3_state_dict_from_jax
from e4s_tpu_torch.models.bisenet import BiSeNet
from e4s_tpu_torch.models.net3 import Net3
from e4s_tpu_torch.ops import modconv as tmc
from e4s_tpu_torch.ops import patch_modconv as tpmc
from e4s_tpu_torch.ops.upfirdn2d import make_kernel
from e4s_tpu_torch.pipelines import swap_core
from e4s_tpu_torch.pipelines.model_io import cast_bf16, materialise

BF = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _bf16(a):
    """A numpy f32 array rounded to bf16: (torch bf16, the same values as
    a jnp bf16 array)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _gate(got, want):
    """The JAX package's bf16 gate: (PSNR over want's range, rel RMSE)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mse = np.mean((got - want) ** 2)
    return (10 * np.log10((want.max() - want.min()) ** 2 / mse),
            np.sqrt(mse) / np.std(want))


# ------------------------------------------------------------ kernel twin


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_bf16_plain_matches_the_jax_kernel(ref):
    rng = np.random.RandomState(0)
    H = W = 16
    Ci = Co = 128
    x, jx = _bf16(rng.randn(1, H, W, Ci))
    w, jw = _bf16(rng.randn(Co, Ci, 3, 3) / np.sqrt(9 * Ci))
    smap, js = _bf16(1 + 0.5 * rng.randn(1, H, W, Ci))
    dmap, jd = _bf16(0.5 + rng.rand(1, H, W, Co))
    if ref == "xla":
        want = jmc._patch_mod_conv_nhwc_xla(jx, jw, js, jd)
    else:
        want = j_pallas(jx, jw, js, jd, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = tpmc.patch_mod_conv3_nhwc(x, w, smap, dmap)
    assert got.dtype == BF
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= _ulp(scale)
    assert np.mean(got == want) > 0.99


def test_bf16_composite_up_kernel_matches_jax():
    rng = np.random.RandomState(1)
    w, jw = _bf16(rng.randn(16, 8, 3, 3) / np.sqrt(72))
    want = jmc._composite_up_kernel(jw, jnp.asarray(j_make_kernel((1, 3, 3, 1)) * 4.0))
    assert want.dtype == jnp.bfloat16
    got = tmc._composite_up_kernel(w, make_kernel((1, 3, 3, 1)) * 4.0)
    assert got.dtype == BF
    gb = got.view(torch.int16).numpy().astype(np.int32)
    wb = np.asarray(want).view(np.int16).astype(np.int32)
    assert np.abs(gb - wb).max() <= 1  # same sign: a difference of bit patterns is in ulps
    assert np.mean(gb == wb) > 0.99


def _kernel_channel(j, k):
    """Input channel (within a 32-channel chunk) at position k of k16 slice
    j, as the bf16 kernel indexes it: thread t reads channels 8t .. 8t+7 of
    a pixel, and word 2j (2j+1) of them is its A pair (2t, 2t+1)
    ((2t+8, 2t+9)) of slice j."""
    return 8 * (k % 8 // 2) + 4 * j + 2 * (k // 8) + k % 2


def test_bf16_weight_tiles_read_as_the_kernel_reads_them():
    """Tile (phase, chunk, block), tap (ty, tx), slice j, row n, column k
    sits at ((((((p nk + c) nco + blk) 3 + ty) 3 + tx) 2 + j) 16 + n//8) 128
    + (k//8) 64 + (n%8) 8 + k%8: the 8x16-byte core matrices of wgmma's
    K-major layout, 128 bytes apart along K (LBO) and 256 along N (SBO), a
    slice 4 KB, a tap 8 KB, a tap row (one weight stage) 24 KB; position k
    of slice j holds the chunk's channel ``_kernel_channel(j, k)``; zero
    past Co and Ci."""
    rng = np.random.RandomState(2)
    P, Co, Ci = 4, 136, 40
    w = torch.from_numpy(rng.randn(P, Co, Ci, 3, 3).astype(np.float32)).to(BF)
    packed = tpmc.pack_weight(w)
    assert packed.dtype == BF and packed.is_contiguous()
    assert tuple(packed.shape) == tpmc.packed_shape(P, Co, Ci, BF)
    nk, nco = -(-Ci // 32), -(-Co // 128)
    p, c, blk, ty, tx, j, n, k = np.meshgrid(
        np.arange(P), np.arange(nk), np.arange(nco), np.arange(3), np.arange(3),
        np.arange(2), np.arange(128), np.arange(16), indexing="ij")
    off = ((((((((p * nk + c) * nco + blk) * 3 + ty) * 3 + tx) * 2 + j) * 16
             + n // 8) * 128) + (k // 8) * 64 + (n % 8) * 8 + k % 8)
    o, i = blk * 128 + n, c * 32 + _kernel_channel(j, k)
    inside = (o < Co) & (i < Ci)
    wn = w.float().numpy()
    want = np.where(inside, wn[p, np.minimum(o, Co - 1), np.minimum(i, Ci - 1),
                               ty, tx], 0.0)
    got = packed.float().reshape(-1).numpy()[off]
    np.testing.assert_array_equal(got, want)
    assert sorted(_kernel_channel(jj, kk) for jj in (0, 1) for kk in range(16)) == list(range(32))


@pytest.mark.parametrize("up", [False, True])
def test_bf16_kernel_indexing_computes_the_conv(up):
    """The bf16 kernel's sum written out on the CPU as it indexes its
    operands: per 32-channel chunk, tap and k16 slice, A from the zero-
    padded halo by ``_kernel_channel`` (x*smap rounded once), B from the
    packed tile at the core-matrix offsets, f32 sums; then dmap in f32 and
    one rounding. Equals the bf16 plain version within one bf16 ulp (both
    round one f32 sum, in another order)."""
    rng = np.random.RandomState(3)
    B, H, W, Ci, Co = 1, 5, 6, 40, 136
    P, s = (4, 2) if up else (1, 1)
    x = torch.from_numpy(rng.randn(B, H, W, Ci).astype(np.float32)).to(BF)
    w = torch.from_numpy((rng.randn(*((P,) if up else ()), Co, Ci, 3, 3)
                          / np.sqrt(9 * Ci)).astype(np.float32)).to(BF)
    smap = torch.from_numpy((1 + 0.5 * rng.randn(B, s * H, s * W, Ci)).astype(np.float32)).to(BF)
    dmap = torch.from_numpy((0.5 + rng.rand(B, s * H, s * W, Co)).astype(np.float32)).to(BF)
    nk, nco = -(-Ci // 32), -(-Co // 128)
    tiles = tpmc.pack_weight(w).float().numpy().reshape(P, nk, nco, 3, 3, 2, 16, 2, 8, 8)
    # B[k, n] of slice j: tile[..., j, n//8, k//8, n%8, k%8]
    Bm = tiles.transpose(0, 1, 2, 3, 4, 5, 7, 9, 6, 8).reshape(P, nk, nco, 3, 3, 2, 16, 128)
    xp = np.zeros((B, H + 2, W + 2, nk * 32), np.float32)
    xp[:, 1:-1, 1:-1, :Ci] = x.float().numpy()
    sm = np.zeros((B, s * H, s * W, nk * 32), np.float32)
    sm[..., :Ci] = smap.float().numpy()
    chan = np.array([[_kernel_channel(j, k) for k in range(16)] for j in (0, 1)])
    out = np.zeros((B, s * H, s * W, Co), np.float32)
    for ph in range(P):
        a, b = ph >> 1, ph & 1
        acc = np.zeros((B, H, W, nco * 128), np.float32)
        for c in range(nk):
            for ty in range(3):
                for tx in range(3):
                    for j in range(2):
                        ch = 32 * c + chan[j]
                        A = (torch.from_numpy(xp[:, ty:ty + H, tx:tx + W][..., ch])
                             .to(BF) * torch.from_numpy(sm[:, a::s, b::s][..., ch]).to(BF))
                        for blk in range(nco):
                            acc[..., blk * 128:(blk + 1) * 128] += (
                                A.float().numpy() @ Bm[ph, c, blk, ty, tx, j])
        y = acc[..., :Co] * dmap.float().numpy()[:, a::s, b::s]
        out[:, a::s, b::s] = torch.from_numpy(y).to(BF).float().numpy()
    plain = tpmc.patch_mod_conv3_up_nhwc_plain if up else tpmc.patch_mod_conv3_nhwc_plain
    want = plain(x, w, smap, dmap).float().numpy()
    assert np.abs(out - want).max() <= _ulp(np.abs(want).max())
    assert np.mean(out == want) > 0.95


def test_bf16_wrapper_refuses_mixed_dtypes():
    x = torch.zeros(1, 4, 4, 16, dtype=BF)
    w = torch.zeros(8, 16, 3, 3, dtype=BF)
    with pytest.raises(TypeError, match="casts nothing"):
        tpmc._launch(x, w, torch.zeros(1, 4, 4, 16), None)
    with pytest.raises(TypeError, match="casts nothing"):
        tpmc._launch(x, w.float(), x, None)
    with pytest.raises(TypeError, match="casts nothing"):
        tpmc._launch(x, w, x, torch.zeros(1, 4, 4, 8))
    with pytest.raises(TypeError):
        tpmc.pack_weight(w.half())


@pytest.mark.parametrize("up", [False, True])
def test_bf16_masked_layer_matches_jax(up):
    """One region-masked layer in bf16 (maps, demod cast, composite, plain
    conv) against the JAX NHWC layer in bf16: within two bf16 ulps of
    max |want| (the demod's f32 rsqrt and the composite may each round to
    the neighbouring bf16 value)."""
    rng = np.random.RandomState(3)
    B, R, Ci, Co, H = 2, 12, 32, 16, 8
    x, jx = _bf16(rng.randn(B, Ci, H, H))
    w, jw = _bf16(rng.randn(Co, Ci, 3, 3) / np.sqrt(9 * Ci))
    s, js = _bf16(1 + 0.3 * rng.randn(B, R, Ci))
    lab = rng.randint(0, R, (B, 16, 16))
    mask = (lab[:, None] == np.arange(R)[None, :, None, None]).astype(np.float32)
    want = jmc.masked_modulated_conv2d_nhwc(
        jnp.transpose(jx, (0, 2, 3, 1)), jw, js, jnp.asarray(mask), up=up)
    assert want.dtype == jnp.bfloat16
    want = np.transpose(np.asarray(want.astype(jnp.float32)), (0, 3, 1, 2))
    got = tmc.masked_modulated_conv2d(
        x.contiguous(memory_format=torch.channels_last), w, s,
        torch.from_numpy(mask), up=up)
    assert got.dtype == BF
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2 * _ulp(np.abs(want).max())


# ------------------------------------------------------------------ Net3

NET_CFG = dict(out_size=128, remaining_layer_idx=9, n_styles=14, encoder_size=64)


def test_bf16_net3_passes_the_jax_bf16_gate():
    """Net3 forward at 128^2 (K = 9): the port in bf16 against the JAX
    package in bf16 and against the port in f32, each at PSNR >= 40 dB and
    relative RMSE <= 3%."""
    S, R = 128, 12
    jnet = JNet3(channels_last=True, **NET_CFG)
    key = jax.random.PRNGKey(0)
    v = numpy_variables(jax.eval_shape(lambda: jnet.init(
        {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)),
        jnp.zeros((1, R, S, S)), latent_avg=jnp.zeros((14, 512)),
        randomize_noise=False)), seed=7)
    rng = np.random.RandomState(0)
    img = rng.rand(1, 3, S, S).astype(np.float32) * 2 - 1
    lab = rng.randint(0, R, (1, S, S))
    mask = (lab[:, None] == np.arange(R)[None, :, None, None]).astype(np.float32)
    la = (rng.randn(14, 512) * 0.1).astype(np.float32)
    vb, ib, mb, lb = cast_pytree_bf16(
        (jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(img),
         jnp.asarray(mask), jnp.asarray(la)))
    want16, _ = jax.jit(lambda *a: jnet.apply(
        a[0], a[1], a[2], latent_avg=a[3], randomize_noise=False))(vb, ib, mb, lb)
    want16 = np.asarray(want16.astype(jnp.float32))

    net = materialise(lambda: Net3(**NET_CFG), net3_state_dict_from_jax(v))
    t_img, t_mask, t_la = (torch.from_numpy(a) for a in (img, mask, la))
    with torch.no_grad():
        got32, _ = net(t_img, t_mask, t_la, randomize_noise=False)
        net16, la16 = cast_bf16(net, t_la)
        got16, _ = net16(t_img.to(BF), t_mask.to(BF), la16, randomize_noise=False)
    assert got16.dtype == BF
    got16 = got16.float().numpy()
    for want in (want16, got32.numpy()):
        psnr, rel = _gate(got16, want)
        assert psnr >= 40.0 and rel <= 0.03, (psnr, rel)


def test_bf16_swap_e2e_matches_jax_bf16():
    """The fused swap with Net3 and latent_avg in bf16 (BiSeNet, the stitch
    and the quantisation in f32) against the JAX program under the same
    cast: >= 40 dB PSNR on uint8, and the parse in f32 on both sides."""
    S = 64
    cfg = dict(out_size=S, remaining_layer_idx=7, n_styles=10, encoder_size=S)
    jnet = JNet3(channels_last=True, **cfg)
    jbis = JBiSeNet(n_classes=19)
    key = jax.random.PRNGKey(0)
    v = numpy_variables(jax.eval_shape(lambda: jnet.init(
        {"params": key, "noise": key}, jnp.zeros((1, 3, S, S)),
        jnp.zeros((1, 12, S, S)), latent_avg=jnp.zeros((10, 512)),
        randomize_noise=False)), seed=3)
    bv = numpy_variables(
        jax.eval_shape(lambda: jbis.init(key, jnp.zeros((1, 3, S, S)))), seed=4)
    rng = np.random.RandomState(5)
    src, tgt = (np.kron(rng.randint(0, 256, (1, 3, 8, 8)), np.ones((8, 8)))
                .astype(np.uint8) for _ in range(2))
    la = rng.randn(10, 512).astype(np.float32)
    vb, lb = cast_pytree_bf16((jax.tree_util.tree_map(jnp.asarray, v),
                               jnp.asarray(la)))
    fn = jax.jit(j_make_swap_e2e(jnet, jbis, parser_size=S))
    want = [np.asarray(a) for a in fn(vb, bv, src, tgt, lb)]

    net, la16 = cast_bf16(
        materialise(lambda: Net3(**cfg), net3_state_dict_from_jax(v)),
        torch.from_numpy(la))
    bis = materialise(lambda: BiSeNet(19), bisenet_state_dict_from_jax(bv))
    assert next(bis.parameters()).dtype == torch.float32
    got = [g.numpy() for g in swap_core.make_swap_e2e(net, bis, parser_size=S)(
        torch.from_numpy(src), torch.from_numpy(tgt), la16)]
    assert got[0].dtype == np.uint8
    assert np.mean(got[1] == want[1]) >= 0.999  # swapped labels
    assert psnr_u8(got[0], want[0]) >= 40.0


def test_bf16_model_io_casts_net3_and_not_the_parser(tmp_path):
    """``load_net3`` under ``opts.bf16``: every floating parameter and
    buffer of Net3 and latent_avg bf16 (the JAX package's
    ``cast_pytree_bf16`` of its variables); the parser stays f32."""
    from e4s_tpu_torch.pipelines.model_io import load_face_parser, load_net3

    opts = types.SimpleNamespace(num_seg_cls=12, start_from_latent_avg=True,
                                 checkpoint_path=None, bf16=True, **{
                                     **NET_CFG, "out_size": 32})
    net, la = load_net3(opts, device="cpu")
    assert la.dtype == BF
    floats = [t for t in list(net.parameters()) + list(net.buffers())
              if t.is_floating_point()]
    assert floats and all(t.dtype == BF for t in floats)
    parser = load_face_parser(types.SimpleNamespace(out_size=32, parser_size=32),
                              None, device="cpu")
    assert all(p.dtype == torch.float32 for p in parser.model.parameters())
