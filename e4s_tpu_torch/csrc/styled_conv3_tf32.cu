// The unmasked StyledConv of the E4S generator (the StyleGAN2 layers from K
// on) as one launch, NHWC, f32 in / f32 out, on Hopper tensor cores (wgmma)
// in the 3xTF32 split:
//
//   out[b,oh,ow,o] = sqrt2 * lrelu_0.2( d[b,o] * sum_{t,i} Wp[t,o,i] * s[b,i]
//                        * x[b,.,.,i]  +  nw * noise[b|0,oh,ow]  +  bias[o] )
//
// A stride-1 layer is a 3x3 conv at the input resolution (oh, ow = h, w). An
// up layer (conv_transpose2 then the 4x4 blur) is the four polyphase 3x3
// convs of its folded 6x6 kernel at the input resolution: phase (a, b)
// writes output pixel (2h+a, 2w+b) (ops/modconv.py::up_phase_weights). The
// four phases read the same input halo, so they lie side by side along N:
// the launch is one stride-1 conv with P * Co output columns, column n
// = phase * Co + o, scattered by the epilogue.
//
// Replaces no TPU kernel: the JAX package's e4s_tpu/ops/modconv.py::
// modulated_conv2d leaves this conv to XLA. It was added because on an H100
// with TF32 off (the configuration is f32) each of these layers ran as five
// to eight passes: x * s, cuDNN's transposed conv on its f32 kernels, * d,
// upfirdn2d's zero-padded copy and depthwise 4x4 blur (cuDNN's grouped
// direct conv), then the noise, bias, LeakyReLU and gain one full pass
// each. At 1024^2 x 32 channels x 8 images each pass moves ~1 GB.
//
// What bounds it on an H100: the four layers of a 1024^2 synthesis (512^2:
// 128 -> 64 up, 64 -> 64; 1024^2: 64 -> 32 up, 32 -> 32) are 0.928 TFLOP a
// call of 8 in polyphase form against ~5.1 GB (x read once, the output
// written once), so they are bound by operations: three TF32 products per
// multiply-add, 165 TFLOP/s in f32 terms, 5.6 ms; memory alone 1.5 ms.
//
// Design (csrc/conv3_tf32.cu's, with the layer's own arithmetic moved in):
//   - an implicit GEMM: M = output pixels of a TH x 16 tile, N = BN output
//     columns, K = 9 taps x Ci; two warpgroups, warpgroup w takes tile
//     columns 8w..8w+7 of every row (TH / 8 accumulators of 64 pixels x BN)
//     and issues wgmma.mma_async m64nBNk8 on TF32, both operands from
//     shared memory by descriptor;
//   - narrow N tiles, so that no block computes padding: 8 x 16 pixels x 64
//     columns (an up layer's four phases in blocks of 64: two phases of a
//     Co = 32 layer, one of a Co = 64 layer; the 64-channel stride-1
//     layer) and 16 x 16 x 32 (the 32-channel stride-1 layer). Both fit
//     two blocks an SM (97 and 78 KB of shared memory), so one block's
//     fill and epilogue overlap the other's tensor work. Measured on an
//     H100 at the four layers, B = 1 and 8, these beat every other tile the
//     kernel was built with (8 or 16 rows x N = 32, 64, 128): one block of
//     128 columns (170 KB, one block an SM) ran the up layers 15-24% slower;
//   - f32 accuracy from the 3xTF32 split: a = a_hi + a_lo, b = b_hi + b_lo,
//     D += a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32;
//   - the style: s[b,i] is constant over a block's pixels, so it is applied
//     once per element per K step, where the halo (landed by cp.async) is
//     split in place into its TF32 high half and beside it the low half:
//     x * s rounds to f32 exactly as the plain path's x * s does, and no
//     map of styles is read;
//   - the weight tile of a K step (9 taps x BN x 8, both halves, packed once
//     per weight by the caller) lands by one bulk (TMA) copy on an
//     mbarrier, into a 2-deep ring with the halo: step i+1's loads go out
//     as soon as both warpgroups are done with step i-1, and its split runs
//     while the tensor cores run step i;
//   - the epilogue applies d, the noise term, the bias, the LeakyReLU and
//     the sqrt(2) gain in f32 in the plain path's order, each a separate
//     rounding (no contraction into FMAs), and stores NHWC once, each
//     phase's column to its own output pixel. d and the bias of the block's
//     columns are staged in shared memory.
// No split K: at batch 1 the four layers' grids are 2048-4096 blocks. Every
// output is summed by one thread in one fixed order, so results repeat bit
// for bit. Edges (H, W not multiples of the tile, the last N block, Ci not
// a multiple of 8) are zero-filled on load and masked on store. Ci must be
// a multiple of one 16-byte copy, 4 channels.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;         // tile columns: 8 a warpgroup
constexpr int BK = 8;          // input channels per K step (one k8 wgmma)
constexpr int STAGES = 2;      // depth of the ring
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int ROW = 16;        // bytes of a core-matrix row: 4 channels
// Weight tile of one tap in the K-major core-matrix layout (no swizzle):
// core matrix = 8 columns (n) x 4 input channels (k), 128 bytes; the two
// k core matrices of row group n/8 sit WLBO bytes apart, row groups WSBO.
constexpr int WLBO = 128;
constexpr int WSBO = 256;
constexpr float SLOPE = 0.2f;
constexpr float GAIN = 1.41421356237309515f;  // (float) sqrt(2), as PyTorch's

template <int TH, int BN>
struct Cfg {
  static_assert(TH == 8 || TH == 16, "tile rows: 8 or 16");
  static_assert(BN == 32 || BN == 64, "N: 32 or 64");
  static constexpr int PH = TH + 2;  // halo rows
  static constexpr int PW = TW + 2;  // halo columns
  static constexpr int MH = TH / 8;  // accumulators of 64 pixels a warpgroup
  // A operand: core matrices of k half kh and 8-pixel run r sit LBO / SBO
  // bytes apart
  static constexpr int ALBO = PH * PW * ROW;
  static constexpr int ASBO = PW * ROW;
  static constexpr int PLANE = 2 * PH * PW * 4;  // floats: one TF32 half of the halo
  static constexpr int WTAP = BN * BK;           // floats: one tap of one half
  static constexpr int WS = 9 * WTAP;            // floats: one TF32 half of the weights
  static constexpr int STAGE = 2 * PLANE + 2 * WS;  // hi, lo halo; hi, lo weights
  static constexpr size_t SMEM = sizeof(float) * STAGE * STAGES;
  // two blocks an SM (228 KB, 1 KB of it reserved a block), so that one
  // block's fill and epilogue overlap the other's tensor work
  static_assert(2 * (SMEM + 2048) <= 233472, "two blocks must fit an SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// v -> (hi, lo): hi = tf32(v), lo = tf32(v - hi), each with its low 13 bits 0
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, hi));
}

// K-major shared-memory matrix descriptor, no swizzle: start address, the
// byte offset between core matrices adjacent in K (lbo) and in M or N (sbo)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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

// D[64 x N] += A[64 x 8] B[8 x N], A and B in shared memory
__device__ __forceinline__ void wgmma_m64n64k8(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k8(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 64)
    wgmma_m64n64k8(d, da, db);
  else
    wgmma_m64n32k8(d, da, db);
}

// The layer's f32 epilogue for one output, each step rounded on its own as
// the plain path's passes round it: * d, + nw * noise, + bias, LeakyReLU,
// * sqrt(2)
__device__ __forceinline__ float finish(float acc, float d, float bias,
                                        float nw, float nz, bool noise) {
  float a = __fmul_rn(acc, d);
  if (noise) a = __fadd_rn(a, __fmul_rn(nw, nz));
  a = __fadd_rn(a, bias);
  a = a > 0.f ? a : __fmul_rn(a, SLOPE);
  return __fmul_rn(a, GAIN);
}

struct Args {
  const float* x;      // [B,H,W,Ci]
  const float* wp;     // [Ci/8][N blocks][hi, lo][9 taps][BN x 8]
  const float* s;      // [B,Ci] style
  const float* d;      // [B,Co] demodulation
  const float* bias;   // [Co]
  const float* noise;  // [1 or B, Ho, Wo], or null
  const float* nw;     // [1] noise strength (read where noise is given)
  float* out;          // [B,Ho,Wo,Co]
  int B, H, W, Ci, Co, up, noise_bstride, tiles_w, nsteps;
};

// K step `step` (input channels 8 step .. 8 step + 7) into ring slot `st`:
// the x halo by cp.async into the slot's high plane, the step's weight tile
// (`wsrc`, contiguous in the packed layout) by one bulk copy counted on
// `bar`.
template <int TH, int BN>
__device__ __forceinline__ void load_step(float* st, const Args& p,
                                          const float* xb, const float* wsrc,
                                          uint64_t* bar, int h0, int w0,
                                          int k0) {
  using C = Cfg<TH, BN>;
  const int tid = threadIdx.x;
  for (int e = tid; e < C::PH * C::PW * 2; e += NTHREADS) {
    const int c = e & 1;  // k half: channels 4c .. 4c+3 of the step
    const int q = e >> 1;
    const int r = h0 - 1 + q / C::PW;
    const int col = w0 - 1 + q % C::PW;
    const int k = k0 + 4 * c;
    const bool ok = r >= 0 && r < p.H && col >= 0 && col < p.W && k < p.Ci;
    const float* src = ok ? xb + ((size_t)r * p.W + col) * p.Ci + k : xb;
    cp_async16(st + (c * C::PH * C::PW + q) * 4, src, ok);
  }
  if (tid == 0)
    bulk_load(st + 2 * C::PLANE, wsrc, sizeof(float) * 2 * C::WS, bar);
}

template <int TH, int BN>
__global__ void __launch_bounds__(NTHREADS, 2)
    styled_conv3_kernel(const Args p) {
  using C = Cfg<TH, BN>;
  constexpr int MH = C::MH;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // weight tile landed
  __shared__ float dsh[BN], bsh[BN];  // d and bias of the block's columns

  const int b = blockIdx.z;
  const int h0 = (blockIdx.x / p.tiles_w) * TH;
  const int w0 = (blockIdx.x % p.tiles_w) * TW;
  const int n_blk = blockIdx.y * BN;  // first output column of the block
  const int ncols = (p.up ? 4 : 1) * p.Co;

  const float* xb = p.x + (size_t)b * p.H * p.W * p.Ci;
  const float* sb = p.s + (size_t)b * p.Ci;
  // this block's weight tile of K step 0; step i is i * gridDim.y tiles on
  const float* wb = p.wp + (size_t)blockIdx.y * 2 * C::WS;
  const size_t wstep = (size_t)gridDim.y * 2 * C::WS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int c0 = 8 * wg;     // the warpgroup's first tile column

  float acc[MH][BN / 2];
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[m][j] = 0.f;

  if (tid < BN) {
    const int n = n_blk + tid;
    const int o = n % p.Co;
    dsh[tid] = n < ncols ? p.d[(size_t)b * p.Co + o] : 0.f;
    bsh[tid] = n < ncols ? p.bias[o] : 0.f;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  load_step<TH, BN>(smem, p, xb, wb, &full[0], h0, w0, 0);
  cp_async_commit();

  for (int i = 0; i < p.nsteps; ++i) {
    float* st = smem + (i % STAGES) * C::STAGE;
    // the step's style, 4 channels of each k half (0 past Ci, where x is 0)
    float4 sv[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = i * BK + 4 * c;
      sv[c] = k < p.Ci ? __ldg(reinterpret_cast<const float4*>(sb + k))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    cp_async_wait_all();
    __syncthreads();  // step i's halo has landed, everyone's copies included

    // x * s, split in place into its TF32 high half, the low half beside
    // it; then make the writes visible to the tensor cores' (async) proxy
    float4* hi = reinterpret_cast<float4*>(st);
    float4* lo = reinterpret_cast<float4*>(st + C::PLANE);
    for (int e = tid; e < C::PLANE / 4; e += NTHREADS) {
      const float4 sc = e < C::PH * C::PW ? sv[0] : sv[1];
      const float4 v = hi[e];
      float4 h, l;
      split_tf32(__fmul_rn(v.x, sc.x), h.x, l.x);
      split_tf32(__fmul_rn(v.y, sc.y), h.y, l.y);
      split_tf32(__fmul_rn(v.z, sc.z), h.z, l.z);
      split_tf32(__fmul_rn(v.w, sc.w), h.w, l.w);
      hi[e] = h;
      lo[e] = l;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t xh = smem_u32(st);
    const uint32_t xl = smem_u32(st + C::PLANE);
    const uint32_t wh = smem_u32(st + 2 * C::PLANE);
    const uint32_t wl = wh + sizeof(float) * C::WS;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t bo = sizeof(float) * tap * C::WTAP;
      const uint64_t dbh = desc(wh + bo, WLBO, WSBO);
      const uint64_t dbl = desc(wl + bo, WLBO, WSBO);
#pragma unroll
      for (int m = 0; m < MH; ++m) {
        const uint32_t ao = ((8 * m + tap / 3) * C::PW + c0 + tap % 3) * ROW;
        const uint64_t dah = desc(xh + ao, C::ALBO, C::ASBO);
        const uint64_t dal = desc(xl + ao, C::ALBO, C::ASBO);
        wgmma_tf32<BN>(acc[m], dal, dbh);
        wgmma_tf32<BN>(acc[m], dah, dbl);
        wgmma_tf32<BN>(acc[m], dah, dbh);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup is done with step i-1
    __syncthreads();  // and so is the other: its ring slot takes step i+1
    if (i + 1 < p.nsteps)
      load_step<TH, BN>(smem + ((i + 1) % STAGES) * C::STAGE, p, xb,
                        wb + (i + 1) * wstep, &full[(i + 1) % STAGES], h0, w0,
                        (i + 1) * BK);
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait_all();

  // epilogue. Fragment row g (+8 for hf = 1) of warp w4's 16 rows of row
  // block m is tile row 8m + 2 w4 + hf, column c0 + g; columns 8j + 2t and
  // 8j + 2t + 1 of the block are acc[m][4j + 2hf] and acc[m][4j + 2hf + 1].
  const int Ho = p.up ? 2 * p.H : p.H;
  const int Wo = p.up ? 2 * p.W : p.W;
  const float nwv = p.noise ? *p.nw : 0.f;
  const bool pairs = (p.Co & 1) == 0;
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = h0 + 8 * m + 2 * (warp & 3) + hf;
      const int col = w0 + c0 + g;
      if (r >= p.H || col >= p.W) continue;
      // the noise at each phase's output pixel
      float nz[4] = {0.f, 0.f, 0.f, 0.f};
      if (p.noise) {
        const float* nb = p.noise + (size_t)b * p.noise_bstride;
        if (p.up) {
#pragma unroll
          for (int ph = 0; ph < 4; ++ph)
            nz[ph] = nb[(size_t)(2 * r + (ph >> 1)) * Wo + 2 * col + (ph & 1)];
        } else {
          nz[0] = nb[(size_t)r * Wo + col];
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int nl = 8 * j + 2 * t;  // the block's columns nl, nl + 1
        // with Co even, columns nl and nl + 1 are channels o, o + 1 of one
        // phase: one 8-byte store; else one column at a time
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_blk + nl + e;
          if ((pairs && e == 1) || n >= ncols) break;
          const int ph = n / p.Co;
          const int o = n - ph * p.Co;
          const int oh = p.up ? 2 * r + (ph >> 1) : r;
          const int ow = p.up ? 2 * col + (ph & 1) : col;
          float* dst = p.out + (((size_t)b * Ho + oh) * Wo + ow) * p.Co + o;
          const float nzv = ph == 0 ? nz[0] : ph == 1 ? nz[1] : ph == 2 ? nz[2] : nz[3];
          const float v0 = finish(acc[m][4 * j + 2 * hf + e], dsh[nl + e],
                                  bsh[nl + e], nwv, nzv, p.noise);
          if (pairs)
            *reinterpret_cast<float2*>(dst) = make_float2(
                v0, finish(acc[m][4 * j + 2 * hf + 1], dsh[nl + 1], bsh[nl + 1],
                           nwv, nzv, p.noise));
          else
            *dst = v0;
        }
      }
    }
}

template <int TH, int BN>
cudaError_t launch(const Args& a, int nblocks_n, cudaStream_t stream) {
  using C = Cfg<TH, BN>;
  // per device, so set on every launch (it costs no device time)
  const cudaError_t e = cudaFuncSetAttribute(
      styled_conv3_kernel<TH, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles_h = (a.H + TH - 1) / TH;
  const dim3 grid(a.tiles_w * tiles_h, nblocks_n, a.B);
  styled_conv3_kernel<TH, BN><<<grid, NTHREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch (0 on success). bn: the N tile, 64
// or 32, which the packed weight `wp` was packed for; it sets the pixel
// tile (8 x 16 at N = 64, 16 x 16 at N = 32). noise
// may be null; noise_bstride is 0 for one noise map shared by the batch,
// else Ho * Wo.
extern "C" int styled_conv3_tf32(const float* x, const float* wp,
                                 const float* s, const float* d,
                                 const float* bias, const float* noise,
                                 const float* nw, float* out, int B, int H,
                                 int W, int Ci, int Co, int up,
                                 int noise_bstride, int bn,
                                 void* stream_ptr) {
  if ((bn != 64 && bn != 32) || Ci % 4 != 0 || B < 1 || H < 1 || W < 1 ||
      Ci < 4 || Co < 1 || (noise && !nw))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ncols = (up ? 4 : 1) * Co;
  const int nblocks_n = (ncols + bn - 1) / bn;
  Args a{x,  wp, s, d, bias, noise, nw, out, B, H, W, Ci, Co, up ? 1 : 0,
         noise_bstride, (W + TW - 1) / TW, (Ci + BK - 1) / BK};
  return static_cast<int>(bn == 64 ? launch<8, 64>(a, nblocks_n, stream)
                                   : launch<16, 32>(a, nblocks_n, stream));
}
