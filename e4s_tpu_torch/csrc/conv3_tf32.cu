// Plain 3x3 convolution, stride 1, zero padding 1, NHWC, f32 in / f32 out,
// on Hopper tensor cores (wgmma) in the 3xTF32 split.
//
//   out[b,h,w,o] = sum_{ty,tx,i} W[o,i,ty,tx] * x[b,h+ty-1,w+tx-1,i]
//
// Replaces no TPU kernel: the JAX package's encoders
// (e4s_tpu/models/encoders.py) leave their convolutions to XLA. It was added
// for the port's IR-SE trunks (models/encoders.py::Conv3x3: the texture
// encoder FSEncoderPSP, the ID loss's IR-SE50, pSp's IR-50), whose stride-1
// 3x3 convs in f32 (TF32 off, as the configuration states) ran on cuDNN's
// f32 SIMT and FFT kernels, capped by the 67 TFLOP/s of f32 outside the
// tensor cores. W arrives packed by the caller, once per weight, in the
// masked-conv kernel's f32 layout (ops/patch_modconv.py::pack_weight, P = 1):
// per K step (8 input channels) and 128-channel block one contiguous 72 KB
// tile, the 9 taps' TF32 high halves, then their low halves, in wgmma's
// K-major core-matrix order, zero-padded past Co and Ci.
//
// What bounds it on an H100: the encoder's convs (16^2-256^2, 64-512
// channels, batch 2-16) do 0.6-4.8 GMAC an image at 200-2000 FLOP per byte
// of device memory, so they are bound by operations: three TF32 products per
// multiply-add (the split), 495 TFLOP/s dense TF32 on the tensor cores, 165
// in f32 terms. Every K step brings a 72 KB weight tile from L2 into each
// SM (12 bytes per clock and SM at a 16x16 pixel tile when the tensor cores
// are busy, ~2.8 TB/s over the card), and the small grids (16^2-32^2 at
// batch 2) give 8-32 blocks for 132 SMs. Measured on an H100 at batch 16,
// the kernel runs at ~0.64 of the 3xTF32 bound and is held by the tensor
// work itself: with no weight traffic it would be 11% faster, with no x
// traffic 5%, with no split 4%, while its wgmma stream alone (both
// operands from shared memory, N = 128) reaches ~0.73 of the bound.
//
// Design (the masked-conv kernel's, csrc/patch_mod_conv3.cu, with what its
// style and demodulation maps cost taken out):
//   - an implicit GEMM with M = output pixels (a TH x TW tile: 16x16, 8x16
//     or 8x8, picked per shape on the host), N = 128 output channels, K = 9
//     taps x Ci; two warpgroups issue wgmma.mma_async m64nNk8 on TF32: at
//     TW = 16 warpgroup w takes tile columns 8w..8w+7 of every row (TH / 8
//     accumulators of 64 pixels) x 128 channels, at 8x8 each takes all 64
//     pixels x 64 channels;
//   - f32 accuracy from the 3xTF32 split: a = a_hi + a_lo, b = b_hi + b_lo,
//     D += a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32 by the
//     tensor cores (plain TF32 would be off by ~5e-4 relative per operand);
//   - both operands from shared memory by descriptor. The (TH+2) x (TW+2)
//     x halo of a K step lands by cp.async (zero-filled at the image edge
//     and past Ci) as [k half][halo row][halo column][4 channels], so each
//     run of 8 pixels of a tile row is one K-major core matrix (8 rows x 16
//     bytes) and the next tile row is one halo row further: a tap's A
//     operand is the halo itself at a shifted start address. Where the
//     masked kernel forms A = x * smap in registers nine times per element,
//     this one splits the halo once per K step, in place into its TF32 high
//     half and beside it the low half, and no thread touches A again;
//   - so a K step's 9 taps x 3 products go out as one wgmma group, with no
//     register A to wait for. The next step's loads (x by cp.async, the
//     weight tile by one bulk (TMA) copy on an mbarrier) go into the other
//     slot of a 2-deep ring as soon as the step before is done (wgmma wait
//     1), so they have a whole step's tensor time to land, and the split of
//     step i+1 runs while the tensor cores run step i. (A third slot does
//     not fit beside two 72 KB weight tiles);
//   - small grids: split-K over Ci (the split count picked per shape on the
//     host to fill the 132 SMs); each split writes its f32 partial sum to a
//     workspace and a second pass sums the splits in a fixed order, so
//     results repeat bit for bit (no atomics).
// Edges (H, W not multiples of the tile; Co not a multiple of 128; the
// last K step) are zero-filled on load and masked on store. Ci must be a
// multiple of one 16-byte copy, 4 channels.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;        // output channels per block
constexpr int BK = 8;          // input channels per K step (one k8 wgmma)
constexpr int STAGES = 2;      // depth of the ring
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int ROW = 16;        // bytes of a core-matrix row: 4 channels
// Weight tile of one tap in the K-major core-matrix layout (no swizzle):
// core matrix = 8 channels (n) x 4 input channels (k), 128 bytes; the two
// k core matrices of row group n/8 sit WLBO bytes apart, row groups WSBO.
constexpr int WLBO = 128;
constexpr int WSBO = 256;
constexpr int WTAP = BN * BK;  // floats per tap tile

template <int TH, int TW>
struct Cfg {
  static_assert((TH == 8 || TH == 16) && (TW == 8 || TW == 16) &&
                    !(TW == 8 && TH == 16),
                "tiles: 8x8, 8x16, 16x16");
  static constexpr int PH = TH + 2;  // halo rows
  static constexpr int PW = TW + 2;  // halo columns
  // TW = 16: a warpgroup per 8 tile columns, MH row blocks of 8 rows (64
  // pixels) x 128 channels; TW = 8: both take the 64 pixels, 64 channels
  static constexpr int MH = TW == 16 ? TH / 8 : 1;
  static constexpr int WN = TW == 16 ? 128 : 64;
  // A operand: core matrices of k half kh and 8-pixel run r sit LBO / SBO
  // bytes apart
  static constexpr int ALBO = PH * PW * ROW;
  static constexpr int ASBO = PW * ROW;
  static constexpr int PLANE = 2 * PH * PW * 4;  // floats: one TF32 half of the halo
  static constexpr int WS = 9 * WTAP;            // floats: one TF32 half of the weights
  static constexpr int STAGE = 2 * PLANE + 2 * WS;  // hi, lo halo; hi, lo weights
  static constexpr size_t SMEM = sizeof(float) * STAGE * STAGES;
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
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
  lo = to_tf32(v - hi);
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

// D[64 x 128] += A[64 x 8] B[8 x 128], A and B in shared memory
__device__ __forceinline__ void wgmma_m64n128k8(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

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

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 128)
    wgmma_m64n128k8(d, da, db);
  else
    wgmma_m64n64k8(d, da, db);
}

struct Args {
  const float* x;   // [B,H,W,Ci]
  const float* wp;  // [Ci/8][Co/128][hi, lo][9 taps][128 x 8]
  float* out;       // [B,H,W,Co], or the [S,B,H,W,Co] workspace
  int B, H, W, Ci, Co, splits, tiles_w, steps_per_split;
};

// One K step (input channels k0 .. k0+7 of this split) into ring slot `st`:
// the x halo by cp.async into the slot's high plane, the step's weight tile
// (`wsrc`, 72 KB contiguous in the packed layout) by one bulk copy counted
// on `bar`.
template <int TH, int TW>
__device__ __forceinline__ void load_step(float* st, const Args& p,
                                          const float* xb, const float* wsrc,
                                          uint64_t* bar, int h0, int w0,
                                          int k0, int kend) {
  using C = Cfg<TH, TW>;
  const int tid = threadIdx.x;
  for (int e = tid; e < C::PH * C::PW * 2; e += NTHREADS) {
    const int c = e & 1;  // k half: channels 4c .. 4c+3 of the step
    const int q = e >> 1;
    const int r = h0 - 1 + q / C::PW;
    const int col = w0 - 1 + q % C::PW;
    const int k = k0 + 4 * c;
    const bool ok = r >= 0 && r < p.H && col >= 0 && col < p.W && k < kend;
    const float* src = ok ? xb + ((size_t)r * p.W + col) * p.Ci + k : xb;
    cp_async16(st + (c * C::PH * C::PW + q) * 4, src, ok);
  }
  if (tid == 0)
    bulk_load(st + 2 * C::PLANE, wsrc, sizeof(float) * 2 * C::WS, bar);
}

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS, 1) conv3_tf32_kernel(const Args p) {
  using C = Cfg<TH, TW>;
  constexpr int WN = C::WN;
  constexpr int MH = C::MH;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // weight tile landed

  const int z = blockIdx.z;
  const int split = z % p.splits;
  const int b = z / p.splits;
  const int h0 = (blockIdx.x / p.tiles_w) * TH;
  const int w0 = (blockIdx.x % p.tiles_w) * TW;
  const int o0 = blockIdx.y * BN;

  const float* xb = p.x + (size_t)b * p.H * p.W * p.Ci;
  // this block's weight tile of K step 0; step s is s * gridDim.y tiles on
  const float* wb = p.wp + (size_t)blockIdx.y * 2 * C::WS;
  const size_t wstep = (size_t)gridDim.y * 2 * C::WS;

  const int kbeg = split * p.steps_per_split * BK;
  const int kend = min(p.Ci, kbeg + p.steps_per_split * BK);
  const int nsteps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int s0 = kbeg / BK;  // this split's first K step

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  // the warpgroup's first tile column and first channel of the block tile
  const int c0 = TW == 16 ? 8 * wg : 0;
  const int n0 = TW == 16 ? 0 : 64 * wg;

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

  if (nsteps > 0)
    load_step<TH, TW>(smem, p, xb, wb + s0 * wstep, &full[0], h0, w0, kbeg,
                      kend);
  cp_async_commit();

  for (int i = 0; i < nsteps; ++i) {
    float* st = smem + (i % STAGES) * C::STAGE;
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    cp_async_wait_all();
    __syncthreads();  // step i's halo has landed, everyone's copies included

    // split the halo in place into its TF32 high half, the low half beside
    // it; then make the writes visible to the tensor cores' (async) proxy
    float4* hi = reinterpret_cast<float4*>(st);
    float4* lo = reinterpret_cast<float4*>(st + C::PLANE);
    for (int e = tid; e < C::PLANE / 4; e += NTHREADS) {
      const float4 v = hi[e];
      float4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      hi[e] = h;
      lo[e] = l;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t xh = smem_u32(st);
    const uint32_t xl = smem_u32(st + C::PLANE);
    const uint32_t wh = smem_u32(st + 2 * C::PLANE) + n0 / 8 * WSBO;
    const uint32_t wl = wh + sizeof(float) * C::WS;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t bo = sizeof(float) * tap * WTAP;
      const uint64_t dbh = desc(wh + bo, WLBO, WSBO);
      const uint64_t dbl = desc(wl + bo, WLBO, WSBO);
#pragma unroll
      for (int m = 0; m < MH; ++m) {
        const uint32_t ao = ((8 * m + tap / 3) * C::PW + c0 + tap % 3) * ROW;
        const uint64_t dah = desc(xh + ao, C::ALBO, C::ASBO);
        const uint64_t dal = desc(xl + ao, C::ALBO, C::ASBO);
        wgmma_tf32<WN>(acc[m], dal, dbh);
        wgmma_tf32<WN>(acc[m], dah, dbl);
        wgmma_tf32<WN>(acc[m], dah, dbh);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup is done with step i-1
    __syncthreads();  // and so is the other: its ring slot takes step i+1
    if (i + 1 < nsteps)
      load_step<TH, TW>(smem + ((i + 1) % STAGES) * C::STAGE, p, xb,
                        wb + (s0 + i + 1) * wstep, &full[(i + 1) % STAGES],
                        h0, w0, kbeg + (i + 1) * BK, kend);
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait_all();

  // epilogue: the sum, or the raw partial sum of this split. Fragment row
  // g (+8 for hf = 1) of warp w4's 16 rows of row block m is tile row
  // 8m + 2 w4 + hf, column c0 + g.
  float* dst = p.out;
  if (p.splits > 1) dst += (size_t)split * p.B * p.H * p.W * p.Co;
  const bool pairs = (p.Co & 1) == 0;
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = h0 + 8 * m + 2 * (warp & 3) + hf;
      const int col = w0 + c0 + g;
      if (r >= p.H || col >= p.W) continue;
      float* row = dst + (((size_t)b * p.H + r) * p.W + col) * p.Co;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int o = o0 + n0 + 8 * j + 2 * t;
        const float v0 = acc[m][4 * j + 2 * hf];
        const float v1 = acc[m][4 * j + 2 * hf + 1];
        if (pairs && o + 1 < p.Co) {
          *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
        } else {
          if (o < p.Co) row[o] = v0;
          if (o + 1 < p.Co) row[o + 1] = v1;
        }
      }
    }
}

// Second pass of split-K: sums the splits in a fixed order.
__global__ void splitk_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[(size_t)s * n + i];
    out[i] = v;
  }
}

template <int TH, int TW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<TH, TW>;
  // per device, so set on every launch (it costs no device time)
  const cudaError_t e = cudaFuncSetAttribute(
      conv3_tf32_kernel<TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles_h = (a.H + TH - 1) / TH;
  const dim3 grid(a.tiles_w * tiles_h, (a.Co + BN - 1) / BN, a.B * a.splits);
  conv3_tf32_kernel<TH, TW><<<grid, NTHREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launches (0 on success). th x tw: the pixel
// tile, 8x8, 8x16 or 16x16. splits > 1 needs `part`, a workspace of
// splits * B * H * W * Co floats.
extern "C" int conv3x3_tf32(const float* x, const float* wp, float* out,
                            float* part, int B, int H, int W, int Ci, int Co,
                            int th, int tw, int splits, void* stream_ptr) {
  const bool tile_ok = (th == 8 && (tw == 8 || tw == 16)) ||
                       (th == 16 && tw == 16);
  if (!tile_ok || splits < 1 || (splits > 1 && !part) || Ci % 4 != 0 ||
      B < 1 || H < 1 || W < 1 || Ci < 4 || Co < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nk = (Ci + BK - 1) / BK;
  Args a{x, wp, splits > 1 ? part : out, B, H, W, Ci, Co,
         splits, (W + tw - 1) / tw, (nk + splits - 1) / splits};
  cudaError_t e = th == 16  ? launch<16, 16>(a, stream)
                  : tw == 16 ? launch<8, 16>(a, stream)
                             : launch<8, 8>(a, stream);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = (size_t)B * H * W * Co;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  splitk_sum_kernel<<<blocks, 256, 0, stream>>>(part, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}
