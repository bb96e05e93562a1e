"""Patch-modulated 3x3 conv: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

    out[b,h,w,o] = dmap[b,h,w,o] * sum_{ty,tx,i} w[o,i,ty,tx]
                                   * smap[b,h,w,i] * x[b,h+ty-1,w+tx-1,i]

x, smap: [B,H,W,Ci]; w: [Co,Ci,3,3] (OIHW, equalised-lr scale applied);
dmap: [B,H,W,Co] or None. This is the whole of a region-masked StyleGAN2
layer once the region styles are gathered per pixel (see ``ops/modconv.py``).
The masked up-conv is the same sum in four polyphase forms: phase (a, b)
has its own 3x3 weight ``wp[2a+b]`` and writes output pixel (2h+a, 2w+b),
with smap/dmap read at that pixel of the [B,2H,2W,*] maps
(``patch_mod_conv3_up_nhwc``).

Replaces the Pallas TPU kernel ``e4s_tpu/ops/pallas/modconv_tpu.py``
(``_kernel``, launched by ``_run`` from ``patch_mod_conv3_nhwc``).

Two instantiations, chosen by the inputs' dtype: f32 in and out, and bf16
in and out, the Pallas kernel's bf16 form (x*smap rounded to bf16,
accumulated in f32, multiplied by dmap in f32, rounded to bf16 once). Mixed
dtypes are refused, never cast.

On an H100 the large layers are bound by operations and the small ones
(4^2..16^2) by the single read of the 512x512x9 weight. Both kernels are
implicit GEMMs on the tensor cores, and an up-conv is one launch over the
four phases. ``csrc/patch_mod_conv3.cu`` (f32, in the 3xTF32 split for
near-f32 accuracy) is fed by TMA bulk copies and cp.async, and its small
layers split K with a second summing pass. ``csrc/patch_mod_conv3_bf16.cu``
is warp-specialised: a producer keeps a TMA ring of 32-channel K chunks
full for wgmma consumers, and the small layers split K across a
thread-block cluster and sum the splits through distributed shared memory
in the same launch. Each source note gives its tiling.

The kernels take the weight packed into per-step tiles (``pack_weight``;
for f32 also split into TF32 halves); the model packs each weight once and
keeps it (``models/stylegan2.py::ModulatedConv2d``). ``ops/kernel_lib.py``
builds each source into its own library and loads it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from e4s_tpu_torch.ops import kernel_lib
from e4s_tpu_torch.ops.kernel_lib import INT, PTR

TILE_N = 128  # output channels of a block
# input channels of a K step: f32 one k8 wgmma depth, bf16 a 32-channel
# chunk (two k16 slices)
TILE_K = {torch.float32: 8, torch.bfloat16: 32}
MAX_CLUSTER = 8  # blocks of a portable thread-block cluster
# each instantiation's library (source stem), C entry and its argument types
_LIBRARY = {
    torch.float32: ("patch_mod_conv3", "patch_mod_conv3_f32",
                    [PTR] * 6 + [INT] * 9 + [PTR]),
    torch.bfloat16: ("patch_mod_conv3_bf16", "patch_mod_conv3_bf16",
                     [PTR] * 5 + [INT] * 9 + [PTR]),
}


def patch_mod_conv3_nhwc_plain(x, w, smap, dmap):
    """The nine-tap einsum, as the JAX package's XLA path computes it
    (``e4s_tpu/ops/modconv.py::_patch_mod_conv_nhwc_xla``): smap * x in x's
    dtype (for bf16 the product rounded once, as the kernel forms it), the
    taps accumulated in f32, dmap applied in f32, one rounding to x's
    dtype."""
    B, H, W, Ci = x.shape
    Co, _, kh, kw = w.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((B, H, W, Co), dtype=acc_dtype, device=x.device)
    for ty in range(kh):
        for tx in range(kw):
            xs = xp[:, ty:ty + H, tx:tx + W, :]
            acc = acc + torch.matmul(
                (smap * xs).to(acc_dtype), w[:, :, ty, tx].t().to(acc_dtype)
            )
    if dmap is not None:
        acc = acc * dmap
    return acc.to(x.dtype)


def patch_mod_conv3_up_nhwc_plain(x, wp, smap, dmap):
    """The masked up-conv as four stride-1 plain calls, one per polyphase
    weight ``wp[2a+b]`` [Co,Ci,3,3], interleaved to [B,2H,2W,Co]. smap
    [B,2H,2W,Ci] and dmap [B,2H,2W,Co] (or None) are read at each phase's
    output pixels."""
    B, H, W, _ = x.shape
    rows = []
    for a in (0, 1):
        row = []
        for b in (0, 1):
            dm = None if dmap is None else dmap[:, a::2, b::2]
            row.append(patch_mod_conv3_nhwc_plain(
                x, wp[2 * a + b], smap[:, a::2, b::2], dm))
        rows.append(torch.stack(row, dim=3))  # [B,H,W,b,Co]
    return torch.stack(rows, dim=2).reshape(B, 2 * H, 2 * W, wp.shape[1])


def _round_tf32(t):
    """f32 -> the nearest TF32 value (ties away from zero), as the card's
    ``cvt.rna.tf32.f32`` rounds: the low 13 mantissa bits become 0."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def packed_shape(P, Co, Ci, dtype=torch.float32, tile_n=TILE_N):
    """Shape of ``pack_weight``'s result for P phases of a ``dtype`` weight
    (``tile_n`` output channels a block: f32 only)."""
    k = TILE_K[dtype]
    nk, nco = -(-Ci // k), -(-Co // tile_n)
    if dtype == torch.bfloat16:
        return (P, nk, nco, 3, 3, 2, TILE_N // 8, 2, 8, 8)
    return (P, nk, nco, 2, 9, tile_n // 8, 2, 8, 4)


def pack_weight(w, tile_n=TILE_N):
    """OIHW [Co,Ci,3,3] (stride-1) or [4,Co,Ci,3,3] (up phases) -> the
    kernel's tiles, zero-padded to whole tiles: per phase, K step and
    128-channel block one contiguous tile in the K-major core-matrix layout
    that wgmma reads (8 rows x 16 bytes per core matrix).

    f32: [P, K step (8 input channels), block, TF32 half, tap, n // 8,
    k // 4, n % 8, k % 4], with blocks of ``tile_n`` channels (a multiple
    of 8; ``ops/styled_conv.py`` packs narrower ones). The halves are the
    3xTF32 split of the weight, made once here instead of in every block:
    hi = tf32(w), lo = tf32(w - hi).

    bf16: [P, K chunk (32 input channels), block, tap row, tap column,
    k16 slice j, n // 8, k // 8, n % 8, k % 8], the weight's own values;
    a tap row (24 KB) is one stage of the kernel's weight ring. Within a
    chunk, position k of slice j holds input channel 8 (k % 8 // 2) + 4 j
    + 2 (k // 8) + k % 2, so that the kernel's thread t finds the A
    fragments of both slices in channels 8t .. 8t+7, one 16-byte load."""
    if w.dtype not in TILE_K:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {w.dtype}")
    wp = w if w.dim() == 5 else w[None]
    P, Co, Ci = wp.shape[:3]
    k = TILE_K[w.dtype]
    _, nk, nco = packed_shape(P, Co, Ci, w.dtype, tile_n)[:3]
    if w.dtype == torch.bfloat16:
        w9 = F.pad(wp.permute(0, 3, 4, 1, 2),
                   (0, nk * k - Ci, 0, nco * TILE_N - Co))
        # [P, ty, tx, block, n//8, n%8, chunk, t, j, k//8, e]: channel
        # 8t + 4j + 2(k//8) + e of the chunk
        t = w9.reshape(P, 3, 3, nco, TILE_N // 8, 8, nk, 4, 2, 2, 2)
        t = t.permute(0, 6, 3, 1, 2, 8, 4, 9, 5, 7, 10)
        return t.reshape(packed_shape(P, Co, Ci, w.dtype)).contiguous()
    w9 = wp.permute(0, 3, 4, 1, 2).reshape(P, 9, Co, Ci)
    w9 = F.pad(w9, (0, nk * k - Ci, 0, nco * tile_n - Co))
    t = w9.reshape(P, 9, nco, tile_n // 8, 8, nk, 2, k // 2).permute(
        0, 5, 2, 1, 3, 6, 4, 7)
    hi = _round_tf32(t)
    return torch.stack([hi, _round_tf32(t - hi)], dim=3)


def plan(B, H, W, Ci, Co, phases, sms=132):
    """(tile rows, tile columns, K splits) for one launch of the f32
    kernel. 16x16-pixel tiles from 64^2 up (each weight tile feeds 256
    pixels), 8x16 where W >= 16, 8x8 below; splits double while the grid
    stays within one wave of ``sms`` blocks (one block fits an SM) and each
    split keeps >= 4 K steps of 8 channels (>= 2 at the last doubling)."""
    th, tw = (16, 16) if H * W >= 64 * 64 else (8, 16) if W >= 16 else (8, 8)
    blocks = (B * phases * -(-H // th) * -(-W // tw)
              * -(-Co // TILE_N))
    steps = -(-Ci // TILE_K[torch.float32])
    splits = 1
    while blocks * splits * 2 <= sms and steps >= 4 * splits:
        splits *= 2
    return th, tw, splits


def plan_bf16(B, H, W, Ci, Co, phases, sms=132):
    """(tile rows, tile columns, K splits) for one launch of the bf16
    kernel, by a cost model fitted to its times on an H100
    (``scripts/sweep_bf16_plans.py``). For each pixel tile (8x8, 8x16,
    16x16) the K splits (each a block of one cluster, summed in shared
    memory) double while the grid stays within one wave of ``sms`` blocks
    and each split keeps >= 2 chunks of 32 channels; clusters of 8 only up
    to 64 blocks in all (the card does not hold more of them at once). The
    plan takes the tile with the least cost, waves x (chunks a split x the
    tile's pixels and 1/10 of its halo, in 64s, + 4 for the block's fill
    and epilogue + splits / 4 for the cluster's sum), the smaller tile on a
    tie."""
    chunks = -(-Ci // TILE_K[torch.bfloat16])
    best = None
    for th, tw in ((8, 8), (8, 16), (16, 16)):
        blocks = B * phases * -(-H // th) * -(-W // tw) * -(-Co // TILE_N)
        splits = 1
        while (splits < MAX_CLUSTER and blocks * splits * 2 <= sms
               and chunks >= 4 * splits
               and not (splits * 2 == MAX_CLUSTER and blocks * MAX_CLUSTER > 64)):
            splits *= 2
        waves = -(-blocks * splits // sms)
        pixels = th * tw + 0.1 * (th + 2) * (tw + 2)
        cost = waves * (chunks / splits * pixels / 64 + 4 + splits / 4)
        if best is None or cost < best[0]:
            best = (cost, (th, tw, splits))
    return best[1]


def _launch(x, w, smap, dmap, packed=None, up=False):
    """One kernel launch (plus the split-K sum where the plan splits), of
    the instantiation of x's dtype (float32 or bfloat16; every input has
    it). ``w``: [Co,Ci,3,3], or [4,Co,Ci,3,3] phase weights for ``up``;
    ``packed``: ``pack_weight(w)``, packed here when None."""
    B, H, W, Ci = x.shape
    P, s = (4, 2) if up else (1, 1)
    Co = w.shape[-4]
    dev, dt = x.device, x.dtype
    if dt not in _LIBRARY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dt}")
    kernel_lib.check("x", x, (B, H, W, Ci), dev, dt)
    kernel_lib.check("smap", smap, (B, s * H, s * W, Ci), dev, dt)
    if dmap is not None:
        kernel_lib.check("dmap", dmap, (B, s * H, s * W, Co), dev, dt)
    want_w = (4, Co, Ci, 3, 3) if up else (Co, Ci, 3, 3)
    if tuple(w.shape) != want_w:
        raise ValueError(f"w has shape {tuple(w.shape)}, want {want_w}")
    if w.dtype != dt:
        raise TypeError(f"w is {w.dtype}, x {dt}: the kernel casts nothing")
    if packed is None:
        packed = pack_weight(w)
    kernel_lib.check("packed weight", packed, packed_shape(P, Co, Ci, dt), dev, dt)
    chunk = 16 // x.element_size()
    if Ci % chunk:
        raise ValueError(f"Ci={Ci}: the {dt} kernel takes a multiple of "
                         f"{chunk} (16-byte copies)")
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    stem, entry, argtypes = _LIBRARY[dt]
    fn = getattr(kernel_lib.load(stem, {entry: argtypes}), entry)
    out = torch.empty((B, s * H, s * W, Co), dtype=dt, device=dev)
    dptr = None if dmap is None else dmap.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dt == torch.bfloat16:
            for name, t in (("x", x), ("smap", smap), ("dmap", dmap)):
                if t is not None and t.data_ptr() % 16:
                    raise ValueError(f"{name} must be 16-byte aligned (TMA)")
            th, tw, splits = plan_bf16(B, H, W, Ci, Co, P, kernel_lib.sm_count(dev))
            err = fn(
                x.data_ptr(), packed.data_ptr(), smap.data_ptr(), dptr,
                out.data_ptr(), B, H, W, Ci, Co, int(up), th, tw, splits, stream,
            )
        else:
            th, tw, splits = plan(B, H, W, Ci, Co, P, kernel_lib.sm_count(dev))
            part = None
            if splits > 1:
                part = torch.empty((splits, *out.shape), dtype=torch.float32,
                                   device=dev)
            err = fn(
                x.data_ptr(), packed.data_ptr(), smap.data_ptr(), dptr,
                out.data_ptr(), None if part is None else part.data_ptr(),
                B, H, W, Ci, Co, int(up), th, tw, splits, stream,
            )
    kernel_lib.check_launch(entry, err)
    patch_mod_conv3_nhwc.launches += 1
    if dt == torch.bfloat16:
        patch_mod_conv3_nhwc.launches_bf16 += 1
    return out


def patch_mod_conv3_nhwc(x, w, smap, dmap, packed=None):
    """Patch-modulated 3x3 conv. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (building it on first use) or raises;
    a gradient goes through the plain version (``kernel_lib.PlainGrad``).
    ``packed``: ``pack_weight(w)`` kept by the caller, or None."""
    if x.device.type == "cpu":
        return patch_mod_conv3_nhwc_plain(x, w, smap, dmap)
    return kernel_lib.with_plain_grad(_launch, patch_mod_conv3_nhwc_plain,
                                      (x, w, smap, dmap), packed, False)


def patch_mod_conv3_up_nhwc(x, wp, smap, dmap, packed=None):
    """The masked up-conv: x [B,H,W,Ci], phase weights wp [4,Co,Ci,3,3],
    smap [B,2H,2W,Ci], dmap [B,2H,2W,Co] or None -> [B,2H,2W,Co]. One
    kernel launch on a CUDA tensor, as ``patch_mod_conv3_nhwc``; the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return patch_mod_conv3_up_nhwc_plain(x, wp, smap, dmap)
    return kernel_lib.with_plain_grad(_launch, patch_mod_conv3_up_nhwc_plain,
                                      (x, wp, smap, dmap), packed, True)


# Kernel launches since the last reset, one per call of either entry, of
# either instantiation (``launches``) and of the bf16 one alone
# (``launches_bf16``); a run sets them to 0 before the path it wants to
# account for and reads them after.
patch_mod_conv3_nhwc.launches = 0
patch_mod_conv3_nhwc.launches_bf16 = 0
