// Region-masked modulated 3x3 convolution, NHWC, f32 in / f32 out, on
// Hopper tensor cores (wgmma) in the 3xTF32 split. The bf16 form has its
// own kernel and design in patch_mod_conv3_bf16.cu, kept apart so that this
// kernel compiles as it does alone (sharing one templated body made ptxas
// serialise its wgmma and cost it 9%).
//
//   out[b,oh,ow,o] = dmap[b,oh,ow,o] *
//       sum_{ty,tx,i} W[ty,tx,o,i] * smap[b,oh,ow,i] * x[b,h+ty-1,w+tx-1,i]
//
// with zero padding outside the image. smap/dmap are the per-pixel style and
// demodulation maps gathered at the OUTPUT pixel, which is what makes one
// conv equal to the reference's 12 per-region convs (see
// e4s_tpu_torch/ops/modconv.py). Two forms, one kernel:
//   - stride 1 (up=0): (oh, ow) = (h, w), one weight;
//   - masked up-conv (up=1): the conv_transpose(stride 2) + blur composite as
//     four polyphase 3x3 convs of x at its own resolution. Phase (a, b) has
//     its own weight and writes (oh, ow) = (2h+a, 2w+b) of the [B,2H,2W,Co]
//     output, reading smap/dmap there; the phase is a grid dimension, so the
//     whole up-conv is one launch with no interleave copy.
// W arrives packed by the caller, once per weight
// (ops/patch_modconv.py::pack_weight): per phase (P = 1 or 4), K step and
// 128-channel block, one contiguous tile holding the 9 taps in wgmma's
// K-major core-matrix layout, zero-padded past Co and Ci. A K step is 8
// input channels and the tile (72 KB) holds the taps' TF32 high halves,
// then their low halves.
//
// Replaces the Pallas TPU kernel e4s_tpu/ops/pallas/modconv_tpu.py::_kernel
// (launched by _run / patch_mod_conv3_nhwc) in its f32 form.
//
// What bounds it on an H100: the 64^2-256^2 layers do 10-19 GFLOP per phase
// at 64-140 FLOP/byte, so they are bound by operations; plain f32 FMAs
// would cap them at 67 TFLOP/s, 3xTF32 on the tensor cores at 165. The
// 4^2-16^2 layers are bound by the one read of the 512x512x9 weight (9.4 MB
// per phase), and a grid of output tiles alone would give them 4-32 blocks
// for 132 SMs.
//
// Design:
//   - an implicit GEMM with M = output pixels (a TH x TW tile: 16x16 from
//     64^2 up, 8x16 or 8x8 below), N = 128 output channels, K = 9 taps x
//     Ci; two warpgroups issue wgmma.mma_async (m64nNk8 on TF32): at 16x16
//     each takes 128 pixels (two m64 accumulators) x 128 channels, at 8x16 64 pixels x 128 channels, at 8x8 all 64 pixels x 64
//     channels. The 16x16 tile feeds each weight tile to 256 pixels,
//     halving the weight traffic from L2 per FLOP against 8x16;
//   - f32: near-f32 accuracy from the 3xTF32 split: a = a_hi + a_lo,
//     b = b_hi + b_lo, D += a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated
//     in f32 by the tensor cores (plain TF32 would be off by ~5e-4
//     relative per operand);
//   - per K step the (TH+2) x (TW+2) halo patch, the smap tile and the
//     weight tile go into one slot of a 2-deep ring in dynamic shared
//     memory: x and smap by cp.async (zero-fill at the image edge and past
//     Ci), the weight tile by one bulk (TMA) copy issued by one thread and
//     completed on an mbarrier. Step i+1 is in flight while the tensor cores
//     run step i; each x element is loaded once per tile and used by all 9
//     taps. wgmma reads B straight from the tile through shared-memory
//     descriptors, so no thread touches the weights;
//   - the A operand x(shifted) * smap(output pixel) is formed in registers
//     straight from shared memory (wgmma takes A from registers), so none of
//     the nine modulated copies of x reaches any memory; the registers of
//     three taps rotate, so a tap's A is built while the two before it run.
//     A pixel's row of a K step is 32 bytes (8 channels), padded to 48 so
//     the fragment loads are free of bank conflicts;
//   - small layers: split-K over Ci (the split count is picked per shape on
//     the host to fill the 132 SMs); each split writes its f32 partial sum
//     to a workspace and a second pass sums the splits in a fixed order,
//     applies dmap, so results repeat bit for bit (no atomics);
//   - otherwise the epilogue multiplies by dmap and stores.
// Edges (H, W not multiples of the tile; Co not a multiple of 128; the
// last K step) are zero-filled on load and masked on store. Ci must be a
// multiple of one 16-byte copy, 4 channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;      // output channels per block
constexpr int BK = 8;        // input channels per K step (one k8 wgmma)
constexpr int STAGES = 2;    // depth of the ring
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int PSTRIDE = 12;  // floats per pixel row of the x / smap tiles
// Weight tile of one tap in the wgmma K-major core-matrix layout (no
// swizzle): core matrix = 8 channels (n) x 4 input channels (k), 128 bytes;
// the two k core matrices of row group n/8 sit LBO bytes apart, row groups
// SBO bytes apart.
constexpr int LBO = 128;
constexpr int SBO = 256;
constexpr int WTAP = BN * BK;  // floats per tap tile

template <int TH, int TW>
struct Cfg {
  static constexpr int BM = TH * TW;   // pixels per block
  static constexpr int PW = TW + 2;    // halo patch width
  static constexpr int PH = TH + 2;
  // 64 pixels: each warpgroup takes them all x 64 channels; otherwise each
  // takes half the pixels, MH row blocks of 64, x all 128 channels
  static constexpr int WN = BM == 64 ? 64 : 128;
  static constexpr int MH = BM == 64 ? 1 : BM / 128;
  static constexpr int XS = PH * PW * PSTRIDE;
  static constexpr int SS = BM * PSTRIDE;
  static constexpr int WS = 9 * WTAP;        // one TF32 half of a step
  static constexpr int STAGE = XS + SS + 2 * WS;  // floats per ring slot
  static constexpr size_t SMEM = sizeof(float) * STAGE * STAGES;
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One bulk (TMA) copy of `bytes` contiguous bytes into shared memory; its
// completion is counted on `bar`. Issued by one thread.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint64_t kmajor_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_m64n128k8(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k8(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc) {
  if constexpr (N == 128)
    wgmma_m64n128k8(d, a, desc);
  else
    wgmma_m64n64k8(d, a, desc);
}

struct Args {
  const float* x;     // [B,H,W,Ci]
  const float* wp;    // [P][Ci/8][Co/128][hi, lo][9 taps][128 x 8]
  const float* smap;  // [B,Ho,Wo,Ci]
  const float* dmap;  // [B,Ho,Wo,Co] or null
  float* out;         // [B,Ho,Wo,Co], or the [S,B,Ho,Wo,Co] workspace
  int B, H, W, Ci, Co, up, splits, tiles_w, steps_per_split;
};

// One K step (input channels k0 .. k0+7 of this split) into ring slot `st`:
// x and smap by cp.async, the step's weight tile (`wsrc`, 72 KB contiguous
// in the packed layout) by one bulk copy counted on `bar`.
template <int TH, int TW>
__device__ __forceinline__ void load_step(float* st, const Args& p,
                                          const float* xb, const float* sb,
                                          const float* wsrc, uint64_t* bar,
                                          int h0, int w0, int pa, int pb,
                                          int k0, int kend) {
  using C = Cfg<TH, TW>;
  const int tid = threadIdx.x;
  const int Wo = p.W << p.up;
  float* xs = st;
  float* ss = st + C::XS;
  float* ws = st + C::XS + C::SS;
  // x halo patch: (PH*PW pixels) x (2 chunks of 4 channels)
  for (int e = tid; e < C::PH * C::PW * 2; e += NTHREADS) {
    const int c = e & 1;
    const int q = e >> 1;
    const int r = h0 - 1 + q / C::PW;
    const int col = w0 - 1 + q % C::PW;
    const int k = k0 + 4 * c;
    const bool ok = r >= 0 && r < p.H && col >= 0 && col < p.W && k < kend;
    const float* src = ok ? xb + ((size_t)r * p.W + col) * p.Ci + k : xb;
    cp_async16(xs + q * PSTRIDE + 4 * c, src, ok);
  }
  // smap at the output pixels of this phase
  for (int e = tid; e < C::BM * 2; e += NTHREADS) {
    const int c = e & 1;
    const int q = e >> 1;
    const int r = h0 + q / TW;
    const int col = w0 + q % TW;
    const int k = k0 + 4 * c;
    const bool ok = r < p.H && col < p.W && k < kend;
    const float* src =
        ok ? sb + ((size_t)((r << p.up) + pa) * Wo + (col << p.up) + pb) * p.Ci + k
           : sb;
    cp_async16(ss + q * PSTRIDE + 4 * c, src, ok);
  }
  // both TF32 halves of the 9 weight taps, already in core-matrix order
  // (zero-padded past Co and Ci by the packing)
  if (tid == 0) bulk_load(ws, wsrc, sizeof(float) * 2 * C::WS, bar);
}

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS, 1)
patch_mod_conv3_tc_kernel(const Args p) {
  using C = Cfg<TH, TW>;
  constexpr int WN = C::WN;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // weight tile landed

  const int P = p.up ? 4 : 1;
  const int z = blockIdx.z;
  const int split = z % p.splits;
  const int ph = (z / p.splits) % P;
  const int b = z / (p.splits * P);
  const int pa = ph >> 1;
  const int pb = ph & 1;
  const int h0 = (blockIdx.x / p.tiles_w) * TH;
  const int w0 = (blockIdx.x % p.tiles_w) * TW;
  const int o0 = blockIdx.y * BN;
  const int Ho = p.H << p.up;
  const int Wo = p.W << p.up;

  const float* xb = p.x + (size_t)b * p.H * p.W * p.Ci;
  const float* sb = p.smap + (size_t)b * Ho * Wo * p.Ci;
  const int nk = (p.Ci + BK - 1) / BK;
  // this block's weight tile of K step 0; step s is s * gridDim.y tiles on
  const float* wb =
      p.wp + ((size_t)ph * nk * gridDim.y + blockIdx.y) * 2 * C::WS;
  const size_t wstep = (size_t)gridDim.y * 2 * C::WS;

  const int kbeg = split * p.steps_per_split * BK;
  const int kend = min(p.Ci, kbeg + p.steps_per_split * BK);
  const int nsteps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  // this thread's fragment rows (pixels) g and g+8 of each 64-row block m
  // (pixel q0 + 64 m), and the warpgroup's first channel in the block tile
  constexpr int MH = C::MH;
  const int q0 = (C::BM == 64 ? 0 : wg * (C::BM / 2)) + (warp & 3) * 16 + g;
  const int n0 = C::BM == 64 ? wg * 64 : 0;
  int qb[MH][2], pr[MH][2];
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = q0 + 64 * m + 8 * hf;
      pr[m][hf] = q * PSTRIDE;
      qb[m][hf] = ((q / TW) * C::PW + q % TW) * PSTRIDE;
    }

  float acc[MH][WN / 2];
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int j = 0; j < WN / 2; ++j) acc[m][j] = 0.f;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int s0 = kbeg / BK;  // this split's first K step

  // Pipeline over K steps: step i+1 is in flight into the other ring slot
  // while the tensor cores run step i.
  if (nsteps > 0)
    load_step<TH, TW>(smem, p, xb, sb, wb + s0 * wstep, &full[0], h0, w0, pa, pb,
                  kbeg, kend);
  cp_async_commit();

  // A registers of three taps in turn (9 taps a step: the rotation carries
  // across steps), so two taps' wgmma stay in flight while the next is built
  uint32_t ahi[3][MH][4], alo[3][MH][4];
  for (int i = 0; i < nsteps; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    cp_async_wait<0>();
    __syncthreads();  // step i has landed, everyone's copies included
    const float* xs = smem + (i % STAGES) * C::STAGE;
    const float* ss = xs + C::XS;
    const float* whi = ss + C::SS;
    const float* wl = whi + C::WS;

    float s[MH][4];  // smap at the fragment's (pixel, channel) slots
#pragma unroll
    for (int m = 0; m < MH; ++m) {
      s[m][0] = ss[pr[m][0] + t];
      s[m][1] = ss[pr[m][1] + t];
      s[m][2] = ss[pr[m][0] + t + 4];
      s[m][3] = ss[pr[m][1] + t + 4];
    }

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * C::PW + tap % 3) * PSTRIDE;
#pragma unroll
      for (int m = 0; m < MH; ++m) {
        uint32_t* ah = ahi[tap % 3][m];
        uint32_t* al = alo[tap % 3][m];
        split_tf32(xs[qb[m][0] + off + t] * s[m][0], ah[0], al[0]);
        split_tf32(xs[qb[m][1] + off + t] * s[m][1], ah[1], al[1]);
        split_tf32(xs[qb[m][0] + off + t + 4] * s[m][2], ah[2], al[2]);
        split_tf32(xs[qb[m][1] + off + t + 4] * s[m][3], ah[3], al[3]);
      }
      const int wo = tap * WTAP + (n0 >> 3) * (SBO / 4);
      const uint64_t dhi = kmajor_desc(whi + wo);
      const uint64_t dlo = kmajor_desc(wl + wo);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MH; ++m) {
        wgmma_tf32<WN>(acc[m], alo[tap % 3][m], dhi);
        wgmma_tf32<WN>(acc[m], ahi[tap % 3][m], dlo);
        wgmma_tf32<WN>(acc[m], ahi[tap % 3][m], dhi);
      }
      wgmma_commit();
      wgmma_wait<2>();  // tap-2's group is done with the A regs tap+1 fills
      if (tap == 2) {
        // this warpgroup is done with step i-1 (tap 0 of step i is); once
        // both are, step i+1 goes into its ring slot
        __syncthreads();
        if (i + 1 < nsteps)
          load_step<TH, TW>(smem + ((i + 1) % STAGES) * C::STAGE, p, xb, sb,
                        wb + (s0 + i + 1) * wstep, &full[(i + 1) % STAGES],
                        h0, w0, pa, pb, kbeg + (i + 1) * BK, kend);
        cp_async_commit();
      }
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // epilogue: dmap and store, or the raw partial sum of this split
  const bool partial = p.splits > 1;
  float* dst = p.out;
  if (partial) dst += (size_t)split * p.B * Ho * Wo * p.Co;
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = q0 + 64 * m + 8 * hf;
      const int r = h0 + q / TW;
      const int col = w0 + q % TW;
      if (r >= p.H || col >= p.W) continue;
      const size_t base =
          (((size_t)b * Ho + (r << p.up) + pa) * Wo + (col << p.up) + pb) * p.Co;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = o0 + n0 + 8 * j + 2 * t + c;
          if (o >= p.Co) continue;
          float v = acc[m][4 * j + 2 * hf + c];
          if (!partial && p.dmap) v *= p.dmap[base + o];
          dst[base + o] = v;
        }
    }
}

// Second pass of split-K: sums the splits in a fixed order, applies dmap.
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ dmap,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[(size_t)s * n + i];
    out[i] = dmap ? v * dmap[i] : v;
  }
}

template <int TH, int TW>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using C = Cfg<TH, TW>;
  // per device, so set on every launch (it costs no device time)
  const cudaError_t e = cudaFuncSetAttribute(
      patch_mod_conv3_tc_kernel<TH, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles_h = (a.H + TH - 1) / TH;
  const dim3 grid(a.tiles_w * tiles_h, (a.Co + BN - 1) / BN,
                  a.B * (a.up ? 4 : 1) * a.splits);
  patch_mod_conv3_tc_kernel<TH, TW><<<grid, NTHREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launches (0 on success). dmap may be null.
// up: 0 stride-1 ([B,H,W,*] maps and output, P = 1), 1 masked up-conv
// ([B,2H,2W,*], P = 4). th x tw: the pixel tile, 8x8, 8x16 or 16x16.
// splits > 1 needs `part`, a workspace of splits * B * Ho * Wo * Co floats.
extern "C" int patch_mod_conv3_f32(const float* x, const float* wp,
                                   const float* smap, const float* dmap,
                                   float* out, float* part, int B, int H,
                                   int W, int Ci, int Co, int up, int th,
                                   int tw, int splits, void* stream_ptr) {
  const bool tile_ok = (th == 8 && (tw == 8 || tw == 16)) ||
                       (th == 16 && tw == 16);
  if (!tile_ok || splits < 1 || (splits > 1 && !part) || Ci % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nk = (Ci + BK - 1) / BK;
  Args a{x, wp, smap, dmap, splits > 1 ? part : out, B, H, W, Ci, Co, up,
         splits, (W + tw - 1) / tw, (nk + splits - 1) / splits};
  cudaError_t e = th == 16  ? launch_tc<16, 16>(a, stream)
                  : tw == 16 ? launch_tc<8, 16>(a, stream)
                             : launch_tc<8, 8>(a, stream);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = (size_t)B * (H << up) * (W << up) * Co;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(part, dmap, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}
