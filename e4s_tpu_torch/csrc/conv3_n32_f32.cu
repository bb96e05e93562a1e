// 3x3 convolution with 32 output channels, stride 1, zero padding 1, NHWC,
// f32 in / f32 out, with the epilogues of RealESRNet's RRDB trunk:
//
//   acc[b,h,w,o] = sum_{i<Ci, ty, tx} W[o,i,ty,tx] * x[b,h+ty-1,w+tx-1,i]
//   y = acc + bias[o]
//   y = lrelu(y, 0.2)                  (optional)
//   y = y * a1 + r1[b,h,w,o]           (optional)
//   y = y * a2 + r2[b,h,w,o]           (optional)
//   out[b,h,w,oc+o] = y
//
// x is read as the first Ci channels of an NHWC buffer whose pixels are xs
// floats apart, optionally through a nearest 2x upsample (x is then
// [B,H/2,W/2,xs] and x[h,w] means x[h/2,w/2]); out is written at channel
// offset oc of a buffer whose pixels are os floats apart; r1, r2 are read at
// channels 0..31 of their buffers. So a residual dense block lives in one
// [B,H,W,160] buffer: conv k reads channels [0, 32k) and writes [32k, 32k+32),
// and no concatenation is ever materialised.
//
// Replaces no TPU kernel: the JAX package's RRDBNet (e4s_tpu/models/gpen/
// rrdbnet.py) leaves its convolutions to XLA. It was added for the port's
// RealESRNet x4 (models/gpen/rrdbnet.py::RRDBNet: 23 RRDBs of 3 dense blocks
// of 5 convs, all with 32 output channels), whose 349 3x3 convs in f32 (TF32
// off, as the configuration states) ran on cuDNN's f32 SIMT implicit GEMM
// (~36% of the card's f32 rate), with a torch.cat before each conv and
// separate bias, LeakyReLU and residual passes.
//
// The sums are cuDNN's, bit for bit. On an H100 cuDNN's f32 kernels for
// these shapes compute each output as one chain of fused multiply-adds from
// 0 over the input channels, then the 3 tap rows, then the 3 tap columns, and
// PyTorch adds the bias after. This kernel runs that chain in that order for
// every output, and its epilogue rounds each operation once, as PyTorch's
// separate passes do. The SR's uint8 image is then the one cuDNN gives: a
// sum in another order (tensor cores in a 3xTF32 split, say, at ~1e-6 of the
// value) moves ~1000 of its 3 M levels, and the restore and the swap after it
// turn a moved level into a moved face region.
//
// What bounds it: the f32 FMA rate, 67 TFLOP/s on an H100 (not the tensor
// cores, whose sums round otherwise). At 256^2 the trunk's 346 convs do 1.25
// TFLOP: 18.7 ms at that rate; their inputs are ~3.5 ms of HBM traffic.
// Measured on an H100 (700 W): 30.0 ms, 0.62 of that rate, against cuDNN's
// 51.5 ms for the convs alone and ~60 ms with its concatenations and passes.
//
// Design:
//   - a block of 256 threads takes a 16 x 16 pixel tile and all 32 output
//     channels; a thread keeps 4 pixels of one tile row x 8 channels (32
//     accumulators), so each x value it loads feeds 8 FMAs and each weight
//     4. Per input channel and tap row it loads 6 x values (its 4 pixels
//     and their two neighbours) and the row's 3 x 8 weights, then runs the
//     row's 3 taps: 96 FMAs for 8 shared-memory loads. (8 pixels a thread,
//     128 threads a block, half the warps an SM, ran 13% slower on an H100);
//   - 8 input channels a stage (unrolled), double-buffered: the next stage's halo
//     ((16+2) x (16+2) pixels x 8 channels) is read into registers while
//     the current one is computed, then stored transposed to
//     [channel][halo row][halo column] (zero outside the image and past
//     Ci), so that a thread's 6 x values are 2 vector loads; its weights
//     ([channel][tap row][tap column][32], packed once on the host) arrive
//     by cp.async;
//   - the epilogue adds the bias and applies the LeakyReLU and residuals at
//     the output pixel, 8 channels (32 bytes) a vector access, each element
//     by the thread that reads its residuals, so out may be r1 or r2 itself.
// Edges (H, W not multiples of the tile) are zero-filled on load and masked
// on store. Ci must be a multiple of one 16-byte load, 4 channels.
//
// The C entry walks a table of convs on the stream, so that a whole trunk
// (349 convs for RealESRNet x4) costs its caller one call.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CO = 32;         // output channels
constexpr int CK = 8;          // input channels per stage
constexpr int TH = 16;         // tile rows
constexpr int TW = 16;         // tile columns
constexpr int NTHREADS = 256;  // 16 rows x 4 runs of 4 columns x 4 channel groups
constexpr int PX = 4;          // pixels a thread
constexpr int HR = TH + 2;     // halo rows
constexpr int HC = TW + 2;     // halo columns
constexpr int HS = 20;         // floats between halo rows (16-byte aligned)
constexpr int XPLANE = HR * HS;          // floats: one channel of the halo
constexpr int XSTAGE = CK * XPLANE;      // floats: a stage's halo
constexpr int WSTAGE = CK * 9 * CO;      // floats: a stage's weights
constexpr int XLOADS = HR * HC * CK / 4;  // float4s of a stage's halo
constexpr int XPER = (XLOADS + NTHREADS - 1) / NTHREADS;
constexpr size_t SMEM = sizeof(float) * 2 * (XSTAGE + WSTAGE);
static_assert(SMEM <= 48 * 1024, "static shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Conv {
  const float* x;     // [B, H >> up, W >> up, xs], channels [0, ci) read
  const float* w;     // packed: [ceil(ci / 8) * 8][3][3][32]
  const float* bias;  // [32]
  float* out;         // [B, H, W, os], at its channel offset
  const float* r1;    // [B, H, W, rs1] or null
  const float* r2;    // [B, H, W, rs2] or null
  float a1, a2;
  int xs, os, rs1, rs2, ci, up, lrelu, B, H, W, tiles_w;
};

// Stage s's halo into registers: float4 e of the stage is channels
// 4 (e & 1) .. +3 of the stage at halo pixel e >> 1; zero outside the image
// and past Ci.
__device__ __forceinline__ void load_x(float4 (&v)[XPER], const Conv& p,
                                       const float* xb, int s, int h0,
                                       int w0) {
  const int xw = p.W >> p.up;  // columns of x
#pragma unroll
  for (int u = 0; u < XPER; ++u) {
    const int e = threadIdx.x + u * NTHREADS;
    const int q = e >> 1;
    const int r = h0 - 1 + q / HC;
    const int col = w0 - 1 + q % HC;
    const int k = s * CK + 4 * (e & 1);
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < XLOADS && r >= 0 && r < p.H && col >= 0 && col < p.W && k < p.ci)
      v[u] = __ldcg(reinterpret_cast<const float4*>(
          xb + ((size_t)(r >> p.up) * xw + (col >> p.up)) * p.xs + k));
  }
}

// ... and from registers into the stage, as [channel][halo row][halo column]
__device__ __forceinline__ void store_x(const float4 (&v)[XPER], float* xs) {
#pragma unroll
  for (int u = 0; u < XPER; ++u) {
    const int e = threadIdx.x + u * NTHREADS;
    if (e >= XLOADS) continue;
    const int q = e >> 1;
    float* d = xs + 4 * (e & 1) * XPLANE + (q / HC) * HS + q % HC;
    d[0] = v[u].x;
    d[XPLANE] = v[u].y;
    d[2 * XPLANE] = v[u].z;
    d[3 * XPLANE] = v[u].w;
  }
}

// Stage s's weights (one contiguous run of the packed layout) by cp.async
__device__ __forceinline__ void load_w(float* ws, const Conv& p, int s) {
  const float* src = p.w + (size_t)s * WSTAGE;
  for (int e = threadIdx.x; e < WSTAGE / 4; e += NTHREADS)
    cp_async16(ws + 4 * e, src + 4 * e);
  cp_async_commit();
}

__global__ void __launch_bounds__(NTHREADS) conv3_n32_kernel(const Conv p) {
  __shared__ __align__(16) float xs[2][XSTAGE];
  __shared__ __align__(16) float ws[2][WSTAGE];

  const int b = blockIdx.z;
  const int h0 = (blockIdx.x / p.tiles_w) * TH;
  const int w0 = (blockIdx.x % p.tiles_w) * TW;
  const float* xb = p.x + (size_t)b * (p.H >> p.up) * (p.W >> p.up) * p.xs;
  const int nst = (p.ci + CK - 1) / CK;

  // this thread: tile row rho, columns 4 j .. 4 j + 3, channels 8 g .. 8 g + 7
  const int lane = threadIdx.x & 31;
  const int g = lane & 3;
  const int j = (lane >> 2) & 3;
  const int rho = 2 * (threadIdx.x >> 5) + (lane >> 4);

  float acc[PX][8];
#pragma unroll
  for (int a = 0; a < PX; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  float4 next[XPER];
  load_w(ws[0], p, 0);
  load_x(next, p, xb, 0, h0, w0);
  store_x(next, xs[0]);
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < nst; ++s) {
    const int cur = s & 1;
    if (s + 1 < nst) {  // the next stage's loads run under this one's FMAs
      load_w(ws[cur ^ 1], p, s + 1);
      load_x(next, p, xb, s + 1, h0, w0);
    }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        // x at halo row rho + r, columns 4 j .. 4 j + 5
        const float* xr = xs[cur] + c * XPLANE + (rho + r) * HS + 4 * j;
        const float4 x0 = *reinterpret_cast<const float4*>(xr);
        const float2 x2 = *reinterpret_cast<const float2*>(xr + 4);
        const float xv[6] = {x0.x, x0.y, x0.z, x0.w, x2.x, x2.y};
        const float* wr = ws[cur] + (c * 3 + r) * 3 * CO + 8 * g;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float4 wa = *reinterpret_cast<const float4*>(wr + t * CO);
          const float4 wb = *reinterpret_cast<const float4*>(wr + t * CO + 4);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int a = 0; a < PX; ++a)
#pragma unroll
            for (int o = 0; o < 8; ++o)
              acc[a][o] = __fmaf_rn(wv[o], xv[a + t], acc[a][o]);
        }
      }
    }
    if (s + 1 < nst) store_x(next, xs[cur ^ 1]);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: the residuals of the thread's 4 pixels are read before any
  // value is written (out may be r1 or r2: each element is read by the
  // thread that writes it)
  const int r = h0 + rho;
  float bias[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) bias[o] = p.bias[8 * g + o];
  float4 q1[PX][2], q2[PX][2];
#pragma unroll
  for (int a = 0; a < PX; ++a) {
    const int col = w0 + PX * j + a;
    const bool ok = r < p.H && col < p.W;
    const size_t pix = ((size_t)b * p.H + r) * p.W + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q1[a][h] = q2[a][h] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && p.r1)
        q1[a][h] = __ldcg(reinterpret_cast<const float4*>(
            p.r1 + pix * p.rs1 + 8 * g + 4 * h));
      if (ok && p.r2)
        q2[a][h] = __ldcg(reinterpret_cast<const float4*>(
            p.r2 + pix * p.rs2 + 8 * g + 4 * h));
    }
  }
#pragma unroll
  for (int a = 0; a < PX; ++a) {
    const int col = w0 + PX * j + a;
    if (r >= p.H || col >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + r) * p.W + col;
    const float* res1 = reinterpret_cast<const float*>(q1[a]);
    const float* res2 = reinterpret_cast<const float*>(q2[a]);
    float y[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float v = __fadd_rn(acc[a][o], bias[o]);
      if (p.lrelu) v = v > 0.f ? v : __fmul_rn(v, 0.2f);
      if (p.r1) v = __fadd_rn(__fmul_rn(v, p.a1), res1[o]);
      if (p.r2) v = __fadd_rn(__fmul_rn(v, p.a2), res2[o]);
      y[o] = v;
    }
    float4* dst = reinterpret_cast<float4*>(p.out + pix * p.os + 8 * g);
    dst[0] = make_float4(y[0], y[1], y[2], y[3]);
    dst[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
}

// A step of the table: buffer indices (r1, r2: -1 for none), the channels
// read, the nearest 2x upsample of x, the channel offset written, LeakyReLU
constexpr int STEP_INTS = 8;  // x, ci, up, out, oc, r1, r2, lrelu

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Plain C entry for ctypes. Runs n convs in order on `stream`, without
// synchronising; returns the first cudaError_t (0 on success), and launches
// nothing when a step is out of bounds.
//
// bufs[nbuf]: NHWC f32 buffers of batch B, dims[3 * nbuf]: each buffer's
// H, W and pixel stride C (channels, a multiple of 4; base 16-byte aligned).
// steps[STEP_INTS * n], alphas[2 * n]: a1 and a2 of each step. Step i uses
// the weight packed at wpack + woff[i] for lci[i] input channels and
// bias + 32 i. A step reads channels [0, ci) of buffer x (H/2 x W/2 when
// up) and writes [oc, oc + 32) of buffer out (H x W), oc a multiple of 4;
// where x is out the channels written lie past those read; r1, r2 (H x W,
// >= 32 channels) may be out only at oc = 0, where each element is read
// before it is written.
extern "C" int conv3_n32_run(const int32_t* steps, const float* alphas, int n,
                             float* const* bufs, const int32_t* dims, int nbuf,
                             int B, const float* wpack, const int64_t* woff,
                             const int32_t* lci, const float* bias,
                             void* stream_ptr) {
  if (n < 0 || nbuf < 1 || B < 1 || !wpack || !bias || !aligned16(wpack))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < nbuf; ++k) {
    const int* d = dims + 3 * k;
    if (!bufs[k] || !aligned16(bufs[k]) || d[0] < 1 || d[1] < 1 || d[2] < 4 ||
        d[2] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) {
    const int* s = steps + STEP_INTS * i;
    const int x = s[0], ci = s[1], up = s[2], o = s[3], oc = s[4];
    if (x < 0 || x >= nbuf || o < 0 || o >= nbuf || up < 0 || up > 1 ||
        ci < 4 || ci % 4 != 0 || ci != lci[i] || woff[i] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int* dx = dims + 3 * x;
    const int* dout = dims + 3 * o;
    if (ci > dx[2] || (dx[0] << up) != dout[0] || (dx[1] << up) != dout[1] ||
        oc < 0 || oc % 4 != 0 || oc + CO > dout[2] || (x == o && oc < ci))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int m = 5; m <= 6; ++m) {
      const int r = s[m];
      if (r == -1) continue;
      if (r < 0 || r >= nbuf || dims[3 * r] != dout[0] ||
          dims[3 * r + 1] != dout[1] || dims[3 * r + 2] < CO ||
          (r == o && oc != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int i = 0; i < n; ++i) {
    const int* s = steps + STEP_INTS * i;
    const int* dout = dims + 3 * s[3];
    Conv c;
    c.x = bufs[s[0]];
    c.w = wpack + woff[i];
    c.bias = bias + CO * i;
    c.out = bufs[s[3]] + s[4];
    c.r1 = s[5] < 0 ? nullptr : bufs[s[5]];
    c.r2 = s[6] < 0 ? nullptr : bufs[s[6]];
    c.a1 = alphas[2 * i];
    c.a2 = alphas[2 * i + 1];
    c.xs = dims[3 * s[0] + 2];
    c.os = dout[2];
    c.rs1 = s[5] < 0 ? 0 : dims[3 * s[5] + 2];
    c.rs2 = s[6] < 0 ? 0 : dims[3 * s[6] + 2];
    c.ci = s[1];
    c.up = s[2];
    c.lrelu = s[7];
    c.B = B;
    c.H = dout[0];
    c.W = dout[1];
    c.tiles_w = (c.W + TW - 1) / TW;
    const dim3 grid(c.tiles_w * ((c.H + TH - 1) / TH), 1, B);
    conv3_n32_kernel<<<grid, NTHREADS, 0, stream>>>(c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
