// Fused depthwise-separable convolution forward (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernels extended_gan_tpu/ops/pallas/dsconv.py:_dsc_kernel
// (launched by _pallas_forward) and _dsc_tiled_kernel (launched by
// _pallas_forward_tiled): one kernel serves both, at every shape. On x of
// shape (N, H, W, C), NHWC f32, with CK = C * kpl depthwise channels in the
// grouped order (channel k reads input channel k / kpl):
//
//   d[n,h,w,k]   = sum_{di,dj} x[n, h+di-1, w+dj-1, k/kpl] * dw[di,dj,k] + dwb[k]
//                  (SAME padding: taps outside the image read 0)
//   out[n,h,w,o] = sum_k d[n,h,w,k] * pw[k,o] + pwb[o]
//
// The depthwise result d never reaches device memory.
//
// Bound: max(bytes / 3.35 TB/s, flops / 67 TFLOP/s f32) with
// flops = 2 * N*H*W * CK * (9 + Cout) and bytes = 4 * (x + out + weights).
// The SmaAt-UNet's wide layers (CK of 256 to 2048 against Cout of 64 to 512)
// do 50 to 500 flops a byte and are bound by operations; the 4-channel input
// layer is bound by bytes. Exact f32 is the contract (the CPU reference is
// exact), so the pointwise product runs on the CUDA cores in f32 FMA, not on
// the tensor cores in TF32.
//
// Design: the pointwise product is a GEMM (N*H*W x CK) @ (CK x Cout) whose
// left operand is made on the fly. One block owns a tile of 64 output pixels
// (flattened over N*H*W, so a tile may span images: at 1x1 to 5x5 an image
// has too few pixels to fill a block) and 64 output channels. A loop inside
// the block walks CK in chunks of 32: the block forms the chunk's depthwise
// outputs for its 64 pixels in shared memory (taps read through the
// read-only cache, which serves their 9-fold reuse), stages the chunk's
// 32 x 64 pointwise weights beside them, and each thread adds a 4 x 4 outer
// product per channel into registers. That loop takes the place of the tiled
// TPU kernel's sequential Cin grid axis: no block reads another's partial
// sum, no atomics, and every output sums in a fixed order (deterministic).
// Shared memory is about 17.5 KB whatever C is, and at most 128 registers a
// thread leave room for two blocks an SM, so one block's loads overlap the
// other's FMAs. The depthwise is recomputed once per 64-channel output tile
// (ceil(Cout / 64) times), at most 14% extra work at the shapes above. Known
// limits: the 9 taps of every depthwise output are separate cached loads, a
// 4 x 4 register tile caps the FMA rate, and nothing is prefetched across
// chunks; staging the haloed input in shared memory, a larger thread tile
// and cp.async double buffering are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;       // output pixels per block
constexpr int kTN = 64;       // output channels per block
constexpr int kTK = 32;       // depthwise channels per chunk
constexpr int kThreads = 256;
constexpr int kDPitch = kTM + 4;  // float4-aligned rows of the depthwise tile

__global__ void __launch_bounds__(kThreads, 2)
dsconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dw,
                  const float* __restrict__ dwb, const float* __restrict__ pw,
                  const float* __restrict__ pwb, float* __restrict__ out,
                  int H, int W, int C, int CK, int Cout, int64_t M) {
  __shared__ __align__(16) float d_s[kTK][kDPitch];
  __shared__ __align__(16) float w_s[kTK][kTN];
  __shared__ int64_t img_s[kTM];  // offset of the pixel's image in x
  __shared__ int row_s[kTM], col_s[kTM];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTN;
  const int kpl = CK / C;
  if (tid < kTM) {
    const int64_t m = m0 + tid;
    const int64_t n = m / ((int64_t)H * W);
    const int r = (int)(m - n * H * W);
    img_s[tid] = n * H * W * C;
    row_s[tid] = m < M ? r / W : -4;  // -4: every tap misses (unused row)
    col_s[tid] = r % W;
  }

  // Depthwise role: channel dk of the chunk, pixels dp0 + 8 * i of the tile.
  const int dk = tid % kTK;
  const int dp0 = tid / kTK;
  // Pointwise role: rows 4 * ty .. 4 * ty + 3, columns 4 * tx .. 4 * tx + 3.
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < CK; k0 += kTK) {
    // ---- depthwise outputs of channels k0 .. k0+31 -----------------------
    const int k = k0 + dk;
    const bool kv = k < CK;
    const int c = kv ? k / kpl : 0;
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = kv ? __ldg(dw + (int64_t)t * CK + k) : 0.f;
    const float bias = kv ? __ldg(dwb + k) : 0.f;
    __syncthreads();  // the pixel table is written; d_s and w_s are free
#pragma unroll 1
    for (int p = dp0; p < kTM; p += kThreads / kTK) {
      const int h = row_s[p], w = col_s[p];
      const float* xi = x + img_s[p] + c;
      float d = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int hh = h + di - 1;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int ww = w + dj - 1;
          if (kv && hh >= 0 && hh < H && ww >= 0 && ww < W)
            d = fmaf(__ldg(xi + ((int64_t)hh * W + ww) * C), wt[di * 3 + dj], d);
        }
      }
      d_s[dk][p] = d + bias;
    }
    // ---- pointwise weights of the chunk: rows k0 .. k0+31 ----------------
#pragma unroll
    for (int i = 0; i < kTK * kTN / kThreads; ++i) {
      const int kk = tid / kTN + (kThreads / kTN) * i;
      const int oo = tid % kTN;
      const bool ok = k0 + kk < CK && o0 + oo < Cout;
      w_s[kk][oo] = ok ? __ldg(pw + (int64_t)(k0 + kk) * Cout + o0 + oo) : 0.f;
    }
    __syncthreads();
    // ---- 64 x 64 tile += d (64 x 32) @ w (32 x 64) ------------------------
#pragma unroll 4
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&d_s[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&w_s[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o < Cout) out[m * Cout + o] = acc[i][j] + __ldg(pwb + o);
    }
  }
}

}  // namespace

// x: (N, H, W, C); dw: (3, 3, CK); dwb: (CK,); pw: (CK, Cout); pwb: (Cout,);
// out: (N, H, W, Cout). All f32, contiguous, CK a multiple of C.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dsconv_fwd(const void* x, const void* dw, const void* dwb,
                          const void* pw, const void* pwb, void* out, int N,
                          int H, int W, int C, int CK, int Cout, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || CK < C || CK % C != 0 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)N * H * W;
  const int64_t tiles = (M + kTM - 1) / kTM;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + kTN - 1) / kTN));
  dsconv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(pw),
      static_cast<const float*>(pwb), static_cast<float*>(out), H, W, C, CK,
      Cout, M);
  return (int)cudaGetLastError();
}
