// Region-masked modulated 3x3 convolution, NHWC, f32 in / f32 accumulate.
//
//   out[b,h,w,o] = dmap[b,h,w,o] *
//       sum_{ty,tx,i} W[ty,tx,i,o] * smap[b,h,w,i] * x[b,h+ty-1,w+tx-1,i]
//
// with zero padding outside the image. smap/dmap are the per-pixel style and
// demodulation maps gathered at the OUTPUT pixel, which is what makes one
// conv equal to the reference's 12 per-region convs (see
// e4s_tpu_torch/ops/modconv.py). W arrives as [3,3,Ci,Co] (the wrapper
// permutes the OIHW weight once per call).
//
// Replaces the Pallas TPU kernel e4s_tpu/ops/pallas/modconv_tpu.py::_kernel
// (launched by _run / patch_mod_conv3_nhwc).
//
// What bounds it on an H100: the stride-1 and up-phase layers of the
// synthesis do 0.08-19 GFLOP per launch over 10-135 MB, i.e. 4-140 FLOP/byte;
// the big layers are bound by f32 FMA throughput (no tensor cores in f32),
// the 4^2-16^2 layers by the one read of the 9.4 MB weight.
//
// Design (simple first; wgmma/TMA and one launch for the four up-phases are
// later work): an implicit GEMM with M = output pixels, N = Co, K = 9*Ci.
//   - one block per (8x8 output-pixel tile, 64-wide Co tile, batch item);
//   - a loop over Ci in chunks of 16; per chunk the 10x10 x halo patch, the
//     8x8 smap tile and the 9 weight taps [9][16][64] go to shared memory;
//   - the A operand is formed in registers as x(shifted) * smap(output
//     pixel), so none of the nine modulated copies ever reaches memory;
//   - 256 threads, each holding a 4-pixel x 4-channel f32 accumulator;
//   - the epilogue multiplies by dmap and stores.
// Edges (H, W not multiples of 8; Ci, Co not multiples of the tile) are
// zero-filled on load and masked on store.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 8;              // output tile rows
constexpr int TW = 8;              // output tile cols
constexpr int BM = TH * TW;        // pixels per block
constexpr int BN = 64;             // output channels per block
constexpr int BK = 16;             // input channels per step
constexpr int PH = TH + 2;         // halo patch rows
constexpr int PW = TW + 2;         // halo patch cols
constexpr int KP = BK + 1;         // padded row: spreads pixel rows over banks
constexpr int NT = 256;            // threads per block

__global__ void __launch_bounds__(NT)
patch_mod_conv3_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w9,
                           const float* __restrict__ smap,
                           const float* __restrict__ dmap,
                           float* __restrict__ out,
                           int H, int W, int Ci, int Co, int tiles_w) {
  __shared__ float xs[PH * PW][KP];
  __shared__ float ss[BM][KP];
  __shared__ __align__(16) float ws[9][BK][BN];

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * BN;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;

  const int tid = threadIdx.x;
  const int tn = tid % 16;           // channels o0 + 4*tn .. +3
  const int tm = tid / 16;           // pixels: row tm/2, cols 4*(tm%2) .. +3
  const int prow = tm >> 1;
  const int pcol = (tm & 1) * 4;

  const size_t img = (size_t)b * H * W;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[j][n] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += BK) {
    // x halo patch [PH*PW][BK], zero outside the image / past Ci
    for (int e = tid; e < PH * PW * BK; e += NT) {
      const int k = e % BK;
      const int q = e / BK;
      const int r = h0 - 1 + q / PW;
      const int c = w0 - 1 + q % PW;
      float v = 0.f;
      if (r >= 0 && r < H && c >= 0 && c < W && k0 + k < Ci)
        v = x[(img + (size_t)r * W + c) * Ci + k0 + k];
      xs[q][k] = v;
    }
    // smap at the output pixels [BM][BK]
    for (int e = tid; e < BM * BK; e += NT) {
      const int k = e % BK;
      const int p = e / BK;
      const int r = h0 + p / TW;
      const int c = w0 + p % TW;
      float v = 0.f;
      if (r < H && c < W && k0 + k < Ci)
        v = smap[(img + (size_t)r * W + c) * Ci + k0 + k];
      ss[p][k] = v;
    }
    // weights [9][BK][BN]
    for (int e = tid; e < 9 * BK * BN; e += NT) {
      const int n = e % BN;
      const int k = (e / BN) % BK;
      const int t = e / (BN * BK);
      float v = 0.f;
      if (o0 + n < Co && k0 + k < Ci)
        v = w9[((size_t)t * Ci + k0 + k) * Co + o0 + n];
      ws[t][k][n] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int k = 0; k < BK; ++k) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = ss[prow * TW + pcol + j][k];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3;
        const int dx = t % 3;
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = xs[(prow + dy) * PW + pcol + j + dx][k] * s[j];
        const float4 bv = *reinterpret_cast<const float4*>(&ws[t][k][tn * 4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = fmaf(a[j], bv.x, acc[j][0]);
          acc[j][1] = fmaf(a[j], bv.y, acc[j][1]);
          acc[j][2] = fmaf(a[j], bv.z, acc[j][2]);
          acc[j][3] = fmaf(a[j], bv.w, acc[j][3]);
        }
      }
    }
    __syncthreads();
  }

  const int r = h0 + prow;
  if (r >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = w0 + pcol + j;
    if (c >= W) continue;
    const size_t base = (img + (size_t)r * W + c) * Co;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int o = o0 + tn * 4 + n;
      if (o < Co) {
        const float d = dmap ? dmap[base + o] : 1.f;
        out[base + o] = acc[j][n] * d;
      }
    }
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch (0 on success). dmap may be null.
extern "C" int patch_mod_conv3_f32(const float* x, const float* w9,
                                   const float* smap, const float* dmap,
                                   float* out, int B, int H, int W, int Ci,
                                   int Co, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (Co + BN - 1) / BN, B);
  patch_mod_conv3_f32_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w9, smap, dmap, out, H, W, Ci, Co, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
