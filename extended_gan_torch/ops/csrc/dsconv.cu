// Fused depthwise-separable convolution (K3) for Hopper, sm_90a: forward
// and backward.
//
// Replaces the TPU kernels extended_gan_tpu/ops/pallas/dsconv.py:_dsc_kernel
// (launched by _pallas_forward) and _dsc_tiled_kernel (launched by
// _pallas_forward_tiled): one forward kernel serves both, at every shape.
// The JAX package's backward (_bwd) is jax.vjp of _reference_dsc, not a
// Pallas kernel; its depthwise part is dsconv_bwd_kernel here. On x of
// shape (N, H, W, C), NHWC f32, with CK = C * kpl depthwise channels in the
// grouped order (channel k reads input channel k / kpl), M = N*H*W:
//
//   d[m,k]   = sum_{di,dj} x[n, h+di-1, w+dj-1, k/kpl] * dw[di,dj,k] + dwb[k]
//              (SAME padding: taps outside the image read 0)
//   out[m,o] = sum_k d[m,k] * pw[k,o] + pwb[o]
//
// With gd = g pw^T (a plain matrix product, left to torch.matmul as the JAX
// package leaves it to XLA), the backward of the depthwise part is
//
//   ddwb[k]    = sum_m gd[m,k]
//   ddw[t,k]   = sum_m x[shift_t(m), k/kpl] * gd[m,k]
//   dx[m,c]    = sum_{j<kpl} sum_t gd[shift_-t(m), c*kpl+j] * dw[t, c*kpl+j]
//
// (the transposed stencil in gather form: no atomics).
//
// Bounds: max(bytes / 3.35 TB/s, flops / 67 TFLOP/s f32). The forward does
// 2 * M * CK * (9 + Cout) flops on x, the weights and out: the SmaAt-UNet's
// wide layers (CK of 256 to 2048 against Cout of 64 to 512) do 50 to 500
// flops a byte and are bound by operations. The depthwise backward does
// 2 * M * CK * 18 flops on gd, x and dx, about 4 flops a byte, and is bound
// by bytes. Exact f32 is the contract (the CPU reference is exact), so every
// product runs on the CUDA cores in f32 FMA, not on the tensor cores in TF32.
//
// Forward design: the pointwise product is a GEMM (M x CK) @ (CK x Cout)
// whose left operand is made on the fly. One block owns a tile of 128 output
// pixels (flattened over N*H*W, so a tile may span images: at 1x1 to 5x5 an
// image has too few pixels to fill a block) and 64 output channels, and
// walks a slice of CK in chunks of 32. For each chunk it copies x at the
// tile's pixels and at every tap of them (128 + 2W + 2 consecutive pixels)
// for the chunk's input channels into shared memory by cp.async, the next
// chunk's copy in flight while this one is used; a thread forms the
// depthwise outputs of one channel along a run of 16 pixels with a 3x3
// window that slides along the row (3 shared loads an output), stores them
// as float4, loads the chunk's 32 x 64 pointwise weights, and each thread
// adds an 8 x 4 outer product per channel into registers, its
// warp 8 x 4 threads, so three shared loads of 128 + 128 + 64 bytes feed 32
// FMAs. Where the tiles leave the card idle (every image of 10x10 or less
// at the UNet's widths), CK is cut into S slices of whole chunks (grid.z):
// each block writes its partial tile to a workspace (S, M, Cout) and
// dsconv_fwd_sum_kernel adds the S partials in slice order, then pwb. The
// chunk loop takes the place of the tiled TPU kernel's sequential Cin grid
// axis: no atomics, every output sums in a fixed order (bit-identical
// runs). When autograd needs it, the blocks of the first output-channel
// tile also write d (M, CK) for the backward's dpw = d^T g.
//
// Backward design: one block of 16 warps owns a run of P pixels and the
// depthwise channels of up to 32 / kpl input channels. It copies gd and x
// at the run's pixels and at every tap of them (P + 2W + 2 consecutive
// pixels) for its channels into shared memory by cp.async, all at once, so
// the whole stage is in flight together; then lane = (pixel slot, channel)
// reads its 9 taps of x and of gd there and adds its ddw and ddwb into
// registers over its pixels. The block adds its lanes in a fixed order
// into one partial a block (through the stage buffer), and
// dsconv_bwd_sum_kernel adds the partials in block order. dx adds its kpl
// depthwise channels by shuffles, in order. Reading taps through the cache,
// one pixel step of a warp after another, left each step waiting on a
// load from device memory: the stage puts a block's loads in flight at once.
//
// The forward takes images up to about 330 pixels wide, the backward up to
// 190 to 250 (their stages of 2W + 2 halo rows must fit a block's shared
// memory); the wrappers raise beyond that.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTN = 64;       // output channels per forward block
constexpr int kTK = 32;       // depthwise channels per chunk
constexpr int kTM = 128;      // output pixels per forward block
constexpr int kThreads = 256;  // the forward's
constexpr int kBwdThreads = 512;  // the backward's: 16 warps share a stage
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int64_t kMaxSmem = 227 * 1024;  // a block's shared memory on sm_90
// the forward's staged x beside its 26 KB of static shared memory
constexpr int64_t kMaxFwdSmem = kMaxSmem - 28 * 1024;

// Forward dynamic shared memory: two stages of x, kTM + 2W + 2 rows of 32
// floats each (a chunk's input channels).
__host__ __device__ inline int64_t fwd_stage_floats(int W) {
  return (int64_t)(kTM + 2 * W + 2) * kTK;
}

__global__ void __launch_bounds__(kThreads, 2)
dsconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dw,
                  const float* __restrict__ dwb, const float* __restrict__ pw,
                  const float* __restrict__ pwb, float* __restrict__ dst,
                  float* __restrict__ d_out, int H, int W, int C, int CK,
                  int Cout, int64_t M, int KS) {
  constexpr int RM = kTM / 16;      // pixels a thread holds in the product
  constexpr int kRun = kTM / 8;     // consecutive pixels a depthwise thread
  constexpr int kDPitch = kTM + 4;  // float4-aligned rows of the depthwise tile
  extern __shared__ __align__(16) float xs_s[];  // 2 x (rows, 32)
  __shared__ __align__(16) float d_s[kTK][kDPitch];
  __shared__ __align__(16) float w_s[kTK][kTN];
  __shared__ int row_s[kTM], col_s[kTM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t m0 = (int64_t)blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTN;
  const int k_lo = blockIdx.z * KS, k_hi = min(CK, k_lo + KS);
  const int kpl = CK / C;
  const int rows = kTM + 2 * W + 2;  // pixels m0 - W - 1 .. m0 + kTM + W
  const int64_t base = m0 - W - 1;
  float* const d_dst = blockIdx.y == 0 ? d_out : nullptr;
  for (int p = tid; p < kTM; p += kThreads) {
    const int64_t m = m0 + p;
    const int r = (int)(m % ((int64_t)H * W));
    row_s[p] = m < M ? r / W : -4;  // -4: every tap misses (unused row)
    col_s[p] = r % W;
  }

  // x of a chunk's input channels at every staged pixel, by cp.async:
  // 16-byte copies where the channels come in whole float4s, else 4-byte
  auto stage = [&](int k0, float* xs) {
    const int c_lo = k0 / kpl, nci = (min(k0 + kTK, k_hi) - 1) / kpl - c_lo + 1;
    const int vec = C % 4 == 0 && c_lo % 4 == 0 && nci % 4 == 0 ? 4 : 1;
    const int per_row = nci / vec;
    for (int e = tid; e < rows * per_row; e += kThreads) {
      const int r = e / per_row, j = vec * (e % per_row);
      const int64_t m = base + r;
      if (m >= 0 && m < M)
        __pipeline_memcpy_async(xs + r * kTK + j, x + m * C + c_lo + j, 4 * vec);
    }
    __pipeline_commit();
  };

  // Depthwise role: channel dk of the chunk, pixels dp0 * kRun + i of the
  // tile; the 3x3 window slides along a row of the staged x.
  const int dk = lane;
  const int dp0 = warp;
  // Pointwise role: a warp holds 8 x 4 threads, so a step's shared loads
  // are 8 float4 of d (128 bytes) and 4 of w (64 bytes): rows q*64 + 4*ty
  // .. +3 for q < RM/4, columns 4 * tx .. +3.
  const int ty = (warp / 4) * 8 + lane / 4, tx = (warp % 4) * 4 + lane % 4;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the pixel table is written
  stage(k_lo, xs_s);
  for (int k0 = k_lo, buf = 0; k0 < k_hi; k0 += kTK, buf ^= 1) {
    const int k = k0 + dk;
    const bool kv = k < k_hi;
    const int cl = kv ? k / kpl - k0 / kpl : 0;  // the lane's staged channel
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = kv ? __ldg(dw + (int64_t)t * CK + k) : 0.f;
    const float bias = kv ? __ldg(dwb + k) : 0.f;
    __pipeline_wait_prior(0);
    __syncthreads();  // this chunk's x is staged; d_s, w_s and the other stage are free
    if (k0 + kTK < k_hi) stage(k0 + kTK, xs_s + (buf ^ 1) * fwd_stage_floats(W));
    const float* const xs = xs_s + buf * fwd_stage_floats(W) + cl;
    // ---- depthwise outputs of channels k0 .. k0+31 -----------------------
    float win[3][3];
#pragma unroll 1
    for (int i0 = 0; i0 < kRun; i0 += 4) {
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = dp0 * kRun + i0 + i;
        const int h = row_s[p], w = col_s[p];
        // slide when the previous pixel of the run is this one's left
        const bool slide = i0 + i > 0 && w > 0 && h >= 0;
        const int rp = p + W + 1;  // the pixel's staged row
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int hh = h + a - 1;
          const bool row_ok = kv && hh >= 0 && hh < H;
          const int rr = rp + (a - 1) * W;
          if (slide) {
            win[a][0] = win[a][1], win[a][1] = win[a][2];
            win[a][2] = row_ok && w + 1 < W ? xs[(rr + 1) * kTK] : 0.f;
          } else {
#pragma unroll
            for (int b = 0; b < 3; ++b)
              win[a][b] = row_ok && w + b - 1 >= 0 && w + b - 1 < W
                              ? xs[(rr + b - 1) * kTK] : 0.f;
          }
        }
        float d = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) d = fmaf(win[t / 3][t % 3], wt[t], d);
        dv[i] = d + bias;
        if (d_dst != nullptr && kv && m0 + p < M) d_dst[(m0 + p) * CK + k] = dv[i];
      }
      *reinterpret_cast<float4*>(&d_s[dk][dp0 * kRun + i0]) =
          make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    // ---- pointwise weights of the chunk: rows k0 .. k0+31 ----------------
#pragma unroll
    for (int i = 0; i < kTK * kTN / kThreads; ++i) {
      const int kk = tid / kTN + (kThreads / kTN) * i;
      const int oo = tid % kTN;
      const bool ok = k0 + kk < k_hi && o0 + oo < Cout;
      w_s[kk][oo] = ok ? __ldg(pw + (int64_t)(k0 + kk) * Cout + o0 + oo) : 0.f;
    }
    __syncthreads();
    // ---- 128 x 64 tile += d (128 x 32) @ w (32 x 64) ----------------------
#pragma unroll 4
    for (int kk = 0; kk < kTK; ++kk) {
      float av[RM];
#pragma unroll
      for (int q = 0; q < RM / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&d_s[kk][64 * q + 4 * ty]);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
      }
      const float4 b = *reinterpret_cast<const float4*>(&w_s[kk][4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // One slice: out (+ pwb). Several: this slice's partial, no bias.
  const bool whole = gridDim.z == 1;
  float* const o_dst = dst + (whole ? 0 : (int64_t)blockIdx.z * M * Cout);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t m = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o < Cout) o_dst[m * Cout + o] = whole ? acc[i][j] + __ldg(pwb + o) : acc[i][j];
    }
  }
}

// out[i] = (ws[0][i] + ws[1][i] + ... + ws[S-1][i]) + pwb[i % Cout], in
// slice order.
__global__ void dsconv_fwd_sum_kernel(const float* __restrict__ ws,
                                      const float* __restrict__ pwb, int S,
                                      int64_t MC, int Cout,
                                      float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MC) return;
  float s = ws[i];
  for (int z = 1; z < S; ++z) s += ws[(int64_t)z * MC + i];
  out[i] = s + __ldg(pwb + (int)(i % Cout));
}

// Block: pixels [m0, m0 + P) with m0 = blockIdx.x * P and the depthwise
// channels of the input channels [blockIdx.y * CC, +CC), P = kBwdWarps *
// ppw * ppl. Warp w takes the run [w * ppw * ppl, +ppw * ppl) of it, lane
// (slot, kk) the pixels slot, slot + ppl, ... of that run and depthwise
// channel kk.
// The block first copies gd and x at pixels [m0 - W - 1, m0 + P + W + 1)
// (the run and every tap of it, flattened over N*H*W) for its channels
// into shared memory with cp.async, all at once, then reads its taps there.
// part: (blocks in x, 10, CK), row t < 9 the block's ddw tap t, row 9 its
// ddwb.
__global__ void __launch_bounds__(kBwdThreads)
dsconv_bwd_kernel(const float* __restrict__ gd, const float* __restrict__ x,
                  const float* __restrict__ dw, float* __restrict__ dx,
                  float* __restrict__ part, int H, int W, int C, int CK,
                  int CC, int ppw, int64_t M) {
  extern __shared__ __align__(16) float stage_s[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpl = CK / C;
  const int kw = CC * kpl;  // lanes of one pixel slot
  const int ppl = 32 / kw;  // pixel slots a warp
  const int c0 = blockIdx.y * CC;
  const int cc_n = min(CC, C - c0);
  const int slot = lane / kw, kk = lane % kw;
  const bool on = slot < ppl && kk < cc_n * kpl;
  const int k = c0 * kpl + (on ? kk : 0);
  const int c = k / kpl;
  const bool lead = on && kk % kpl == 0;  // writes dx[., c]

  // ---- stage gd (rows x kw) and x (rows x CC) in shared memory ----------
  const int P = kBwdWarps * ppw * ppl;
  const int rows = P + 2 * W + 2;
  const int64_t m0 = (int64_t)blockIdx.x * P, base = m0 - W - 1;
  float* const gs = stage_s;
  float* const xs = stage_s + rows * kw;
  // 16-byte copies where every row segment is whole float4s, else 4-byte
  const int vec = CK % 4 == 0 && C % 4 == 0 && CC % 4 == 0 && cc_n == CC
                      ? 4 : 1;
  for (int e = threadIdx.x; e < rows * kw / vec; e += kBwdThreads) {
    const int r = e / (kw / vec), j = vec * (e % (kw / vec));
    const int64_t m = base + r;
    // without dx only the run's own gd is read
    const bool want = dx != nullptr || (r > W && r <= W + P);
    if (want && m >= 0 && m < M && j < cc_n * kpl)
      __pipeline_memcpy_async(gs + vec * e, gd + m * CK + c0 * kpl + j,
                              4 * vec);
  }
  for (int e = threadIdx.x; e < rows * CC / vec; e += kBwdThreads) {
    const int r = e / (CC / vec), j = vec * (e % (CC / vec));
    const int64_t m = base + r;
    if (m >= 0 && m < M && j < cc_n)
      __pipeline_memcpy_async(xs + vec * e, x + m * C + c0 + j, 4 * vec);
  }
  __pipeline_commit();

  float wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = on ? __ldg(dw + (int64_t)t * CK + k) : 0.f;
  float gw[9], gb = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) gw[t] = 0.f;
  const int64_t first = m0 + (int64_t)warp * ppw * ppl + slot;
  const int64_t hw = (int64_t)H * W;
  int64_t img = (first / hw) * hw;  // the pixel's image, as a pixel offset
  int h = (int)((first - img) / W), w = (int)((first - img) % W);
  __pipeline_wait_prior(0);
  __syncthreads();

  const int cl = kk / kpl;  // the lane's input channel within the block
  for (int i = 0; i < ppw; ++i) {
    const int64_t m = first + (int64_t)i * ppl;
    const bool live = on && m < M;
    // the pixel's staged row; an idle lane (slot == ppl) reads the row of
    // the run's first pixel, since its own pixel may lie past the run
    const int r = on ? (int)(m - base) : W + 1;
    // a tap of any pixel of the run lies within the staged rows; outside
    // the image (or for a dead lane) its value is taken as 0
    float g0 = gs[r * kw + kk];
    g0 = live ? g0 : 0.f;
    gb += g0;
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int hh = h + t / 3 - 1, ww = w + t % 3 - 1;
      const bool ok = live && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int rt = r + (t / 3 - 1) * W + t % 3 - 1;
      const float xv = xs[rt * CC + cl];
      gw[t] = fmaf(ok ? xv : 0.f, g0, gw[t]);
      if (dx != nullptr) {
        // the transposed stencil: gd's tap at offset (di-1, dj-1) meets
        // dw's tap (1-di+1, 1-dj+1), index 8 - t
        const float gv = gs[rt * kw + kk];
        v = fmaf(ok ? gv : 0.f, wt[8 - t], v);
      }
    }
    if (dx != nullptr) {
      // dx[m, c]: the kpl lanes of c, added in order by their leader
      float sum = v;
      for (int j = 1; j < kpl; ++j) sum += __shfl_down_sync(0xffffffffu, v, j);
      if (lead && live) dx[m * C + c] = sum;
    }
    // next pixel of the slot: ppl further on
    w += ppl;
    while (w >= W) {
      w -= W;
      if (++h == H) h = 0, img += hw;
    }
  }

  // The block's partial: its lanes of each channel, warp by warp, slot by
  // slot, in that order, summed through the staging buffer
  // (bwd_smem_bytes leaves room for 10 * kBwdThreads floats).
  __syncthreads();
  float* const red_s = stage_s;
#pragma unroll
  for (int t = 0; t < 9; ++t) red_s[t * kBwdThreads + threadIdx.x] = gw[t];
  red_s[9 * kBwdThreads + threadIdx.x] = gb;
  __syncthreads();
  const int n_out = cc_n * kpl;
  float* const p = part + (int64_t)blockIdx.x * 10 * CK + c0 * kpl;
  for (int e = threadIdx.x; e < 10 * n_out; e += kBwdThreads) {
    const int t = e / n_out, ko = e % n_out;
    float s = 0.f;
    for (int wi = 0; wi < kBwdWarps; ++wi)
      for (int si = 0; si < ppl; ++si)
        s += red_s[t * kBwdThreads + wi * 32 + si * kw + ko];
    p[(int64_t)t * CK + ko] = s;
  }
}

// Dynamic shared memory of a backward block: gd and x of its P pixels and
// their taps, P + 2W + 2 rows of CC * kpl and CC floats, and at least room
// for the block's partial sum, 10 * kBwdThreads floats.
int64_t bwd_smem_bytes(int W, int C, int CK, int CC, int ppw) {
  const int kw = CC * (CK / C);
  const int64_t rows = (int64_t)kBwdWarps * ppw * (32 / kw) + 2 * (int64_t)W + 2;
  return max(rows * (kw + CC), (int64_t)10 * kBwdThreads) * (int64_t)sizeof(float);
}

// grads[e] = sum over blocks b, in order, of part[b][e], for e < 10 * CK:
// (9, CK) ddw then (CK,) ddwb.
__global__ void dsconv_bwd_sum_kernel(const float* __restrict__ part,
                                      int blocks, int E,
                                      float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(int64_t)b * E + e];
  grads[e] = s;
}

}  // namespace

// x: (N, H, W, C); dw: (3, 3, CK); dwb: (CK,); pw: (CK, Cout); pwb: (Cout,);
// out: (N, H, W, Cout); d: (N, H, W, CK) or null (not written). All f32,
// contiguous, CK a multiple of C. KS: the depthwise channels of a slice of
// CK, a positive multiple of 32; with S = ceil(CK / KS) > 1 slices, ws holds
// S * N*H*W * Cout floats of scratch. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int dsconv_fwd(const void* x, const void* dw, const void* dwb,
                          const void* pw, const void* pwb, void* out, void* d,
                          void* ws, int N, int H, int W, int C, int CK,
                          int Cout, int KS, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || CK < C || CK % C != 0 || Cout < 1 ||
      KS < kTK || KS % kTK != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)N * H * W;
  const int S = (CK + KS - 1) / KS;
  if (S > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (M + kTM - 1) / kTM;
  const int64_t smem = 2 * fwd_stage_floats(W) * (int64_t)sizeof(float);
  if (tiles > 0x7fffffff || S > 65535 || smem > kMaxFwdSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dsconv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + kTN - 1) / kTN), S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dsconv_fwd_kernel<<<grid, kThreads, (size_t)smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(pw),
      static_cast<const float*>(pwb), static_cast<float*>(S > 1 ? ws : out),
      static_cast<float*>(d), H, W, C, CK, Cout, M, KS);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const int64_t MC = M * Cout;
  dsconv_fwd_sum_kernel<<<(unsigned)((MC + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(pwb), S, MC,
      Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// gd: (N, H, W, CK); x: (N, H, W, C); dw: (3, 3, CK); dx: (N, H, W, C) or
// null (not computed); part: blocks * 10 * CK floats of scratch; grads: 10 *
// CK floats, ddw (3, 3, CK) then ddwb (CK,). CC: input channels a block,
// with CC * kpl <= 32; ppw: pixels a lane; blocks: ceil(N*H*W / (16 * ppw
// * (32 / (CC * kpl)))), the pixel runs. Returns cudaGetLastError().
extern "C" int dsconv_bwd(const void* gd, const void* x, const void* dw,
                          void* dx, void* part, void* grads, int N, int H,
                          int W, int C, int CK, int CC, int ppw, int blocks,
                          void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || CK < C || CK % C != 0 || CC < 1 ||
      CC > C || CC * (CK / C) > 32 || ppw < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)N * H * W;
  const int64_t run = (int64_t)kBwdWarps * ppw * (32 / (CC * (CK / C)));
  if ((M + run - 1) / run != blocks) return (int)cudaErrorInvalidValue;
  const int64_t smem = bwd_smem_bytes(W, C, CK, CC, ppw);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dsconv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)((C + CC - 1) / CC));
  dsconv_bwd_kernel<<<grid, kBwdThreads, (size_t)smem, s>>>(
      static_cast<const float*>(gd), static_cast<const float*>(x),
      static_cast<const float*>(dw), static_cast<float*>(dx),
      static_cast<float*>(part), H, W, C, CK, CC, ppw, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = 10 * CK;
  dsconv_bwd_sum_kernel<<<(E + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), blocks, E, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
