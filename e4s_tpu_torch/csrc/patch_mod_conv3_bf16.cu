// Region-masked modulated 3x3 convolution, NHWC, bf16 in / bf16 out with
// f32 accumulation, on Hopper: a warp-specialised implicit GEMM (TMA ring,
// wgmma), launched as thread-block clusters.
//
//   out[b,oh,ow,o] = bf16( dmap[b,oh,ow,o] *
//       sum_{ty,tx,i} W[ty,tx,o,i] * bf16(smap[b,oh,ow,i] * x[b,h+ty-1,w+tx-1,i]) )
//
// with zero padding outside the image, the taps summed in f32 and dmap
// applied in f32 before the one rounding. Two forms, one kernel, as in the
// f32 kernel (csrc/patch_mod_conv3.cu): stride 1 (up=0), and the masked
// up-conv (up=1) as four polyphase 3x3 convs of x at its own resolution,
// phase (a, b) writing output pixel (2h+a, 2w+b) and reading smap/dmap
// there; the phase is a grid dimension, so an up-conv is one launch.
//
// Replaces the bf16 form of the Pallas TPU kernel
// e4s_tpu/ops/pallas/modconv_tpu.py::_kernel (launched by _run /
// patch_mod_conv3_nhwc with itemsize 2): x*smap formed in bf16, f32
// accumulation, dmap in f32, one rounding to bf16.
//
// What bounds it on an H100: the 32^2-256^2 layers do 2-19 GFLOP per launch
// at 300-1000 FLOP per byte of device memory, so they are bound by the
// tensor cores' 989 TFLOP/s, and then by what feeds them: the bytes each
// SM pulls from L2 per operation, the barrier and wait overhead per K
// step, and the instructions that form the A operand (x*smap differs per
// tap, so A is formed in registers, nine times per x element). The
// 4^2-16^2 layers are bound by the one read of the 512x512x9 weight (4.7
// MB per phase) and by latency: a grid of output tiles alone gives them 4-32
// blocks for 132 SMs.
//
// Design, and what each part does about that:
//   - an implicit GEMM with M = output pixels (a TH x TW tile), N = 128
//     output channels, K = 9 taps x Ci: one consumer warpgroup per 64
//     pixels of the tile, each with one m64n128 f32 accumulator (64
//     registers a thread);
//   - K steps of 32 input channels (BKC): per tap two m64n128k16 wgmma per
//     warpgroup, so a barrier wait buys 2x the tensor work of a 16-channel
//     step. The channels of a chunk are permuted (by the host's
//     packing of the weight, ops/patch_modconv.py::pack_weight) so that a
//     thread's A fragments of both k16 slices are the 16 contiguous bytes
//     of one pixel row: one 16-byte shared load per pixel row and tap,
//     and the smap row once per chunk, not once per tap;
//   - A = x*smap in one instruction per pair (mul.rn.bf16x2: the exact
//     product rounded once, the Pallas kernel's bf16 product);
//   - a warp-specialised ring: one thread of a producer warpgroup issues
//     every load, the consumer warpgroups only wait on mbarriers, run wgmma
//     and release slots (no __syncthreads in the main loop). x's (TH+2) x (TW+2) halo
//     and the smap tile of a chunk arrive by two TMA tensor copies into a
//     ring of 2-4 slots (the tensor map's out-of-bounds zero fill is the image
//     edge, the ragged Ci and the padding); the weight arrives per tap row
//     (3 taps x 128 x 32, 24 KB) into a ring of up to 6 slots, so the
//     loads of the next tap rows are in flight while one runs. The
//     producer hands registers to the consumers (setmaxnreg): 16x16 runs
//     640 threads, 96 registers each at launch, and its consumers need
//     more. Even so ptxas serialises the 16x16 instantiation's wgmma
//     (C7512, too few registers for two taps in flight at 112), so it
//     waits on each tap's group (LAG 0); 8x8 and 8x16 keep one in flight;
//   - L2 bytes per operation: at a 16x16 tile a K chunk moves 20,736
//     bytes of x halo, 16,384 of smap and 73,728 of weight into the SM for
//     18.87 MFLOP, 170 FLOP per byte (8x16: 101, 8x8: 56). Multicasting
//     each weight tile to a cluster of pixel tiles would cut the weight's
//     share, but on an H100 it measured slower than no multicast at every
//     main-path stage (the kernel does not reach the L2's rate yet), so the
//     kernel has no such path;
//   - split-K inside a cluster: the small layers split the chunks over S
//     blocks of one cluster (S <= 8, a portable cluster); after the loop
//     each block stages its f32 partial sum in its own shared memory, and
//     block r sums the S partials of its share of the tile through
//     distributed shared memory (ld.shared::cluster) in rank order, applies
//     dmap and stores: one launch, no workspace, and the same bits every
//     run;
//   - the epilogue stages the f32 tile in shared memory, reads dmap and
//     writes the output in 16-byte vectors, one pixel's 256 bytes by 16
//     neighbouring threads.
// Pixel tiles: 16x16 (four consumer warpgroups), 8x16 (two) and 8x8 (one).
// Ci must be a multiple of 8 (16-byte rows for the tensor maps); the last
// chunk, the image edge and Co past the tile are zero-filled on load and
// masked on store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                  // output channels per block
constexpr int BKC = 32;                  // input channels per K chunk
constexpr int TAP_BYTES = BN * BKC * 2;  // one tap's weight tile, 8 KB
constexpr int SLICE_BYTES = TAP_BYTES / 2;   // one k16 slice of it
constexpr int WROW_BYTES = 3 * TAP_BYTES;    // a tap row: one weight stage
constexpr int ROW_BYTES = BKC * 2;       // a pixel's 32 channels, 64 bytes
constexpr int STG_PITCH = BN + 8;        // floats per staged pixel row
constexpr int MAX_CLUSTER = 8;           // portable cluster size
// K-major core matrices (8 rows x 16 bytes, no swizzle): the two k core
// matrices of a slice sit LBO bytes apart, the 8-channel row groups SBO
constexpr int LBO = 128;
constexpr int SBO = 256;

template <int TH, int TW>
struct CfgB {
  static constexpr int BM = TH * TW;
  static constexpr int PW = TW + 2;
  static constexpr int PH = TH + 2;
  // one consumer warpgroup per 64 pixels, each x all 128 channels (one
  // m64n128 accumulator, 64 floats a thread), and a producer warpgroup
  static constexpr int NCONS = BM / 64 * 128;
  static constexpr int NTHREADS = NCONS + 128;
  // registers a thread (setmaxnreg): a block starts with BASE each (what
  // __launch_bounds__ leaves), the producer gives all but PRODUCER_REGS
  // back, and the consumers take no more than that frees (more would wait
  // forever), at most 232
  static constexpr int PRODUCER_REGS = 32;
  static constexpr int CAP = 65536 / NTHREADS / 8 * 8;
  static constexpr int BASE = CAP < 232 ? CAP : 232;
  static constexpr int MORE =
      (BASE + 128 * (BASE - PRODUCER_REGS) / NCONS) / 8 * 8;
  static constexpr int CONSUMER_REGS = MORE < 232 ? MORE : 232;
  // wgmma groups a consumer keeps in flight past the one it just issued:
  // one where registers allow (the next tap's A is formed meanwhile), none
  // at 16x16, whose 112 registers do not hold a second tap's A
  static constexpr int LAG = CONSUMER_REGS >= 168 ? 1 : 0;
  static constexpr int XB = PH * PW * ROW_BYTES;  // x halo of a chunk
  static constexpr int SB = BM * ROW_BYTES;       // smap tile of a chunk
  static constexpr int XSLOT = XB + SB;
  // x ring slots (chunks): a small tile computes a chunk in less time
  // than a cold load of the next takes, so it keeps more chunks in flight
  static constexpr int XST = BM == 64 ? 4 : BM == 128 ? 3 : 2;
  static constexpr int WOFF = XST * XSLOT;        // the weight ring
  // weight ring slots (tap rows): what the block's shared memory holds
  // beside the x ring, at most 6 (two chunks)
  static constexpr int WFIT = (232448 - 1024 - WOFF) / WROW_BYTES;
  static constexpr int WST = WFIT < 6 ? WFIT : 6;
  static constexpr int RING = WOFF + WST * WROW_BYTES;
  static constexpr int STG = BM * STG_PITCH * 4;  // f32 tile, after the loop
  static constexpr int SMEM = RING > STG ? RING : STG;
  static_assert(XB % 128 == 0 && SB % 128 == 0, "TMA destinations 128-aligned");
  static_assert(SMEM <= 232448 - 1024, "more shared memory than a block may use");
};

struct ArgsB {
  const __nv_bfloat16* wp;    // packed: [P][Ci/32][Co/128][9 taps][2][16][2][8][8]
  const __nv_bfloat16* dmap;  // [B,Ho,Wo,Co] or null
  __nv_bfloat16* out;         // [B,Ho,Wo,Co]
  int H, W, Ci, Co, up, splits, tiles_w;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the N consumer threads only (named barrier 1)
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A wait that has not ended after 2^26 polls (seconds; every wait of a
// correct launch ends in microseconds) traps, so that a broken ring fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes into this block's shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t local, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(cta));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// The bf16 pair x*s: each exact product rounded to nearest even once.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

__device__ __forceinline__ uint64_t kmajor_desc(uint32_t a) {
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

// D[64 x N] += A[64 x 16] B[16 x N] on bf16, f32 accumulate; A from
// registers, B (K-major) through `desc`.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a,
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int TH, int TW>
__global__ void __launch_bounds__(CfgB<TH, TW>::NTHREADS, 1)
patch_mod_conv3_bf16_kernel(const ArgsB p, const __grid_constant__ CUtensorMap tmx,
                            const __grid_constant__ CUtensorMap tms) {
  using C = CfgB<TH, TW>;
  constexpr int NCONS = C::NCONS;
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int WST = C::WST;
  constexpr int XST = C::XST;
  __shared__ __align__(8) uint64_t xfull[XST], xempty[XST], wfull[WST], wempty[WST];

  const int tid = threadIdx.x;
  const int S = p.splits;  // K splits: a cluster of S blocks, one tile
  const int P = p.up ? 4 : 1;
  const int ph = blockIdx.z % P;
  const int b = blockIdx.z / P;
  const int pa = ph >> 1;
  const int pb = ph & 1;
  const int tile = S > 1 ? blockIdx.x / S : blockIdx.x;
  const int h0 = (tile / p.tiles_w) * TH;
  const int w0 = (tile % p.tiles_w) * TW;
  const int o0 = blockIdx.y * BN;
  const int nk = (p.Ci + BKC - 1) / BKC;
  // this split's chunks: an even share, in order
  const int split = S > 1 ? (int)cluster_rank() : 0;
  const int c_beg = split * nk / S;
  const int nch = (split + 1) * nk / S - c_beg;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < XST; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], NCONS / 32);
    }
#pragma unroll
    for (int s = 0; s < WST; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (tid == NCONS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tms))
                   : "memory");
      constexpr int W_ELEMS = WROW_BYTES / 2;
      // this block's weight tiles: (phase, chunk, channel block), 9 taps each
      const __nv_bfloat16* wb =
          p.wp + ((size_t)(ph * nk + c_beg) * gridDim.y + blockIdx.y) * 3 * W_ELEMS;
      const size_t wchunk = (size_t)gridDim.y * 3 * W_ELEMS;
      const int bh = b * p.H + h0;  // smap's merged (image, row) coordinate
      for (int c = 0; c < nch; ++c) {
        const int xs = c % XST;
        if (c >= XST) mbar_wait(&xempty[xs], ((c / XST) - 1) & 1);
        uint8_t* xdst = smem + xs * C::XSLOT;
        const int k = (c_beg + c) * BKC;
        mbar_expect_tx(&xfull[xs], C::XSLOT);
        tma_load_4d(xdst, &tmx, k, w0 - 1, h0 - 1, b, &xfull[xs]);
        tma_load_5d(xdst + C::XB, &tms, k, pb, w0, pa, bh, &xfull[xs]);
        for (int ty = 0; ty < 3; ++ty) {
          const int s = 3 * c + ty;
          const int j = s % WST;
          if (s >= WST) mbar_wait(&wempty[j], ((s / WST) - 1) & 1);
          uint8_t* wdst = smem + C::WOFF + j * WROW_BYTES;
          const __nv_bfloat16* src = wb + c * wchunk + ty * W_ELEMS;
          mbar_expect_tx(&wfull[j], WROW_BYTES);
          bulk_load(wdst, src, WROW_BYTES, &wfull[j]);
        }
      }
    }
    // the producer's part of the cluster barriers below; the two roles
    // never reconverge (so that setmaxnreg holds)
    if (S > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  {
    const int lane = tid & 31;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group: channels 8t .. 8t+7 of a chunk
    // this thread's fragment rows (pixels) q and q+8 of its warpgroup's 64
    // (q % TW < 8: q+8 is the next pixel row at TW = 8, the same at 16)
    const int q = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
    const int xo0 = ((q / TW) * C::PW + q % TW) * ROW_BYTES + 16 * t;
    constexpr int XO1 = (TW == 8 ? C::PW : 8) * ROW_BYTES;  // row q+8 from row q

    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

    const uint32_t wring = smem_u32(smem + C::WOFF);
    for (int c = 0; c < nch; ++c) {
      const int xs = c % XST;
      mbar_wait(&xfull[xs], (c / XST) & 1);
      const uint8_t* xsl = smem + xs * C::XSLOT;
      // smap at the fragment's two pixels, this chunk's channels
      const uint4 s0 = *reinterpret_cast<const uint4*>(xsl + C::XB + q * ROW_BYTES + 16 * t);
      const uint4 s1 =
          *reinterpret_cast<const uint4*>(xsl + C::XB + (q + 8) * ROW_BYTES + 16 * t);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const int s = 3 * c + ty;
        const int j = s % WST;
        mbar_wait(&wfull[j], (s / WST) & 1);
        const uint64_t desc = kmajor_desc(wring + j * WROW_BYTES);
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          // A of both k16 slices: word 2k (2k+1) of a row holds the
          // fragment's pair (2t, 2t+1) ((2t+8, 2t+9)) of slice k
          const int off = (ty * C::PW + tx) * ROW_BYTES;
          const uint4 x0 = *reinterpret_cast<const uint4*>(xsl + xo0 + off);
          const uint4 x1 = *reinterpret_cast<const uint4*>(xsl + xo0 + XO1 + off);
          uint32_t a[2][4];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            a[k][0] = mul_bf16x2(word(x0, 2 * k), word(s0, 2 * k));
            a[k][1] = mul_bf16x2(word(x1, 2 * k), word(s1, 2 * k));
            a[k][2] = mul_bf16x2(word(x0, 2 * k + 1), word(s0, 2 * k + 1));
            a[k][3] = mul_bf16x2(word(x1, 2 * k + 1), word(s1, 2 * k + 1));
          }
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 2; ++k)
            wgmma_m64n128k16(acc, a[k],
                             desc + ((tx * TAP_BYTES + k * SLICE_BYTES) >> 4));
          wgmma_commit();
          wgmma_wait<C::LAG>();
          // the tap LAG taps back is done: release what it was the last
          // reader of (a weight tap row; after tap 8, the x slot)
          const int tap = 3 * ty + tx;
          if (C::LAG == 0) {
            if (tap % 3 == 2 && lane == 0) mbar_arrive(&wempty[j]);
            if (tap == 8 && lane == 0) mbar_arrive(&xempty[xs]);
          } else if (tap % 3 == 0 && (tap > 0 || c > 0)) {
            const int sd = tap > 0 ? s - 1 : 3 * c - 1;
            if (lane == 0) mbar_arrive(&wempty[sd % WST]);
            if (tap == 0 && lane == 0) mbar_arrive(&xempty[(c - 1) % XST]);
          }
        }
      }
    }
    wgmma_wait<0>();
    consumer_sync<NCONS>();  // every consumer is done with the ring: stage over it
    float* stg = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(stg + (q + 8 * hf) * STG_PITCH + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    consumer_sync<NCONS>();
  }
  if (S > 1) cluster_sync();  // every split's partial sum is staged

  {
    // -------------------------------------------------------------- epilogue
    // 8-channel pieces of the tile, 16 per pixel; block r of a split
    // cluster takes every S-th run of NCONS pieces and sums the S partial
    // sums in rank order
    const int Ho = p.H << p.up;
    const int Wo = p.W << p.up;
    const uint32_t stg = smem_u32(smem);
    for (int e = tid + NCONS * split; e < C::BM * 16; e += NCONS * S) {
      const int q = e >> 4;
      const int ch = (e & 15) * 8;
      const int o = o0 + ch;
      const int r = h0 + q / TW;
      const int col = w0 + q % TW;
      if (r >= p.H || col >= p.W || o >= p.Co) continue;
      const int at = (q * STG_PITCH + ch) * 4;
      float v[8];
      if (S == 1) {
        const float4 lo = *reinterpret_cast<const float4*>(smem + at);
        const float4 hi = *reinterpret_cast<const float4*>(smem + at + 16);
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      } else {
        // every split's piece in flight at once, then summed in rank order
        float4 part[MAX_CLUSTER][2];
#pragma unroll
        for (int sp = 0; sp < MAX_CLUSTER; ++sp)
          if (sp < S) {
            part[sp][0] = ld_cluster_f4(stg + at, sp);
            part[sp][1] = ld_cluster_f4(stg + at + 16, sp);
          }
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
#pragma unroll
        for (int sp = 0; sp < MAX_CLUSTER; ++sp)
          if (sp < S) {
            v[0] += part[sp][0].x, v[1] += part[sp][0].y;
            v[2] += part[sp][0].z, v[3] += part[sp][0].w;
            v[4] += part[sp][1].x, v[5] += part[sp][1].y;
            v[6] += part[sp][1].z, v[7] += part[sp][1].w;
          }
      }
      const size_t base =
          (((size_t)b * Ho + (r << p.up) + pa) * Wo + (col << p.up) + pb) * p.Co + o;
      if ((p.Co & 7) == 0) {
        // o + 8 <= Co: Co and o are multiples of 8
        if (p.dmap) {
          const uint4 dv = *reinterpret_cast<const uint4*>(p.dmap + base);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 df = __bfloat1622float2(d2[i]);
            v[2 * i] *= df.x;
            v[2 * i + 1] *= df.y;
          }
        }
        uint4 ov;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
        for (int i = 0; i < 4; ++i) o2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        *reinterpret_cast<uint4*>(p.out + base) = ov;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (o + i >= p.Co) break;
          float y = v[i];
          if (p.dmap) y *= __bfloat162float(p.dmap[base + i]);
          p.out[base + i] = __float2bfloat16_rn(y);
        }
      }
    }
  }
  // no block leaves while a peer may still read its staged sums
  if (S > 1) cluster_sync();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn) return fn;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiledFn>(ptr);
  return fn;
}

// A bf16 tensor map with a box of `box` elements per dim (dim 0 innermost),
// no swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides_bytes,
              const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
            dims, strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TH, int TW>
cudaError_t launch_bf16(const ArgsB& a, const void* x, const void* smap, int B,
                        cudaStream_t stream) {
  using C = CfgB<TH, TW>;
  const int S = a.up ? 2 : 1;
  const cuuint64_t ci = a.Ci;
  // x [B,H,W,Ci]: box (32 channels, the halo patch)
  CUtensorMap tmx, tms;
  const cuuint64_t xd[4] = {ci, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)B};
  const cuuint64_t xs[3] = {ci * 2, ci * 2 * a.W, ci * 2 * a.W * a.H};
  const cuuint32_t xb[4] = {BKC, TW + 2, TH + 2, 1};
  // smap [B,S*H,S*W,Ci] as (Ci, column phase, W, row phase, B*H): box
  // (32 channels, one phase, TW, one phase, TH) is the phase's output tile
  const cuuint64_t sd[5] = {ci, (cuuint64_t)S, (cuuint64_t)a.W, (cuuint64_t)S,
                            (cuuint64_t)B * a.H};
  const cuuint64_t ss[4] = {ci * 2, ci * 2 * S, ci * 2 * S * a.W,
                            ci * 2 * S * S * a.W};
  const cuuint32_t sb[5] = {BKC, 1, TW, 1, TH};
  if (!make_map(&tmx, x, 4, xd, xs, xb) || !make_map(&tms, smap, 5, sd, ss, sb))
    return cudaErrorInvalidValue;

  cudaError_t e = cudaFuncSetAttribute(patch_mod_conv3_bf16_kernel<TH, TW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.H + TH - 1) / TH) * a.tiles_w;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.splits, (a.Co + BN - 1) / BN, B * (a.up ? 4 : 1));
  cfg.blockDim = dim3(C::NTHREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, patch_mod_conv3_bf16_kernel<TH, TW>, a, tmx, tms);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

__global__ void mul_bf16x2_kernel(const uint32_t* __restrict__ x,
                                  const uint32_t* __restrict__ s,
                                  uint32_t* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = mul_bf16x2(x[i], s[i]);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch (0 on success). x [B,H,W,Ci], wp
// (pack_weight of a bf16 weight), smap [B,Ho,Wo,Ci], dmap [B,Ho,Wo,Co] (or
// null) and out [B,Ho,Wo,Co] are bf16, 16-byte aligned; up: 0 stride-1
// (Ho = H, P = 1), 1 masked up-conv (Ho = 2H, P = 4). th x tw: the pixel
// tile, 8x8, 8x16 or 16x16. splits: K splits reduced in a cluster (1-8,
// at most the number of 32-channel chunks). Ci must be a multiple of 8.
extern "C" int patch_mod_conv3_bf16(const void* x, const void* wp,
                                    const void* smap, const void* dmap,
                                    void* out, int B, int H, int W, int Ci,
                                    int Co, int up, int th, int tw, int splits,
                                    void* stream_ptr) {
  const bool tile_ok = (th == 8 && (tw == 8 || tw == 16)) ||
                       (th == 16 && tw == 16);
  const int nk = (Ci + BKC - 1) / BKC;
  const bool aligned = ((uintptr_t)x | (uintptr_t)wp | (uintptr_t)smap |
                        (uintptr_t)dmap | (uintptr_t)out) % 16 == 0;
  if (!tile_ok || splits < 1 || splits > nk || splits > MAX_CLUSTER ||
      Ci % 8 != 0 || !aligned || B < 1 || H < 1 || W < 1 || Co < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf = __nv_bfloat16;
  ArgsB a{static_cast<const bf*>(wp), static_cast<const bf*>(dmap),
          static_cast<bf*>(out), H, W, Ci, Co, up, splits, (W + tw - 1) / tw};
  const cudaError_t e = th == 16  ? launch_bf16<16, 16>(a, x, smap, B, stream)
                        : tw == 16 ? launch_bf16<8, 16>(a, x, smap, B, stream)
                                   : launch_bf16<8, 8>(a, x, smap, B, stream);
  return static_cast<int>(e);
}

// The kernel's A-operand product alone (mul_bf16x2), which nothing but the
// tests calls: out[i] = the bf16 pairs x[i] * s[i], each rounded once (n
// pairs).
extern "C" int patch_mod_conv3_bf16_product(const void* x, const void* s,
                                            void* out, int n, void* stream_ptr) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  mul_bf16x2_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(s),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
