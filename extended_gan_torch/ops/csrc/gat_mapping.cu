// Fused conv-mapping bottleneck (K2), forward and backward, for Hopper, sm_90a.
//
// Replaces the TPU kernels extended_gan_tpu/ops/pallas/gat_mapping.py:
// _fwd_kernel (launched by _fwd) and _bwd_kernel (launched by _bwd). Per head
// and image, on x of shape (H, W, Cin), f32, SAME padding, stride 1:
//
//   h1  = relu(conv3x3(x;  W1) + b1)     Cin -> F   (F = 74 in GAT3D)
//   h2  = relu(conv1x1(h1; W2) + b2)     F   -> F
//   out =      conv3x3(h2; W3) + b3      F   -> Cout
//
// and the backward: dx (when asked) and dW1, db1, dW2, db2, dW3, db3 summed
// over every image. Weights are torch's OIHW with a leading head axis,
// (NH, O, I, k, k); every head reads the same x. Images are (b, v) pairs of a
// (B, H, W, C, V) tensor, image n = b * V + v (V = 1 reads plain NHWC), and
// out, g and dx keep that layout behind the head axis: the GAT3D mapping's
// own (B, H, W, T, V) -> (NH, B, H, W, T', V), with no transposes around the
// launch.
//
// Bound: operations. The forward does 2 * (9*Cin*F + F*F + 9*F*Cout) flops a
// pixel and head (21,608 at Cin = Cout = 4, F = 74) against 32 bytes of x and
// out, far above the card's flop:byte balance. Exact f32 is the contract (the
// TPU kernel runs Precision.HIGHEST), so every product is an f32 FMA on the
// CUDA cores; the tensor cores' TF32 would not match the plain version.
//
// Design. The TPU kernel keeps a whole image's 74-wide intermediates in VMEM;
// one 80x80 intermediate is 1.9 MB here, against 227 KB of shared memory a
// block. So each image is cut into 10x10 output tiles. A tile needs h1 and h2
// on its 12x12 neighbourhood (Q) and x on 14x14 (X); h1 and h2 stay in shared
// memory (channel-major, odd pitch: a warp reading consecutive pixels of one
// channel, or one pixel of consecutive channels, hits distinct banks), and the
// halo costs 44% more work in the first two layers. SAME padding of the
// intermediates: h1 and h2 are zeroed at every Q pixel outside the image, as
// the TPU kernel masks them, which also zeroes their ReLU gates there.
//
// One block per SM and head-slice: grid (G, NH); the block loads its head's
// weights into shared memory once and walks the jobs (image, tile) blockIdx.x,
// blockIdx.x + G, ... in order. The conv layers give each thread one pixel and
// four output channels (one 16-byte weight load per four FMAs).
//
// Backward, per job: recompute h1, h2 on Q; dW3 += h2 x g over the tile; dh2
// from g on Q (when dx is wanted, else on the tile) gated by h2 > 0, in place
// of h2; dW2 += da2 x h1 over the tile (4x4 register tiles); dh1 from da2
// gated by h1 > 0, in place of h1; dW1 += da1 x x over the tile; then dx on the
// tile from da1 on Q. The TPU kernel sums the weight gradients across its
// sequential grid cells; CUDA blocks run concurrently, so each block keeps its
// own sums in shared memory over its fixed list of jobs, writes them once as a
// partial (G partials a head, 10,956 floats each), and a second kernel adds
// the G partials of each entry in a fixed order. dx of several heads that read
// the same x is written per head and summed over heads, in order, by a third.
// No float atomics: the results are bit-identical from run to run.
//
// Known limits: one 512-thread block an SM (the backward holds ~210 KB of
// shared memory), every product reads an operand from shared memory, and the
// dW sums of a tile are dot products over its 100 pixels by few threads.
// Larger register tiles, a tensor-core path for a TF32 option and overlapping
// the next job's loads are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 10;            // output tile side
constexpr int kQ = kT + 2;        // h1 / h2 neighbourhood side
constexpr int kX = kT + 4;        // x / g window side
constexpr int kTT = kT * kT;
constexpr int kQP = kQ * kQ + 1;  // channel pitches, odd
constexpr int kXP = kX * kX + 1;
constexpr int kSplit = 4;         // F split of the Cout- and Cin-wide outputs
constexpr int kThreads = 512;
constexpr int kMaxC = 8;          // Cin, Cout at most
constexpr int kSmemLimit = 232448;

struct Dims {
  int NH, B, V, H, W, Cin, F, Cout, Fp, tiles_x, tiles, jobs;
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int grad_floats(int Cin, int F, int Cout) {
  return F * Cin * 9 + F + F * F + F + Cout * F * 9 + Cout;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// Element (b, y, x, c, v) of a (B, H, W, C, V) tensor.
__device__ __forceinline__ int64_t at(const Dims& d, int C, int b, int y, int x,
                                      int c, int v) {
  return ((((int64_t)b * d.H + y) * d.W + x) * C + c) * d.V + v;
}

__device__ __forceinline__ void decode(const Dims& d, int j, int& b, int& v,
                                       int& ty0, int& tx0) {
  const int n = j / d.tiles, t = j % d.tiles;
  b = n / d.V;
  v = n % d.V;
  ty0 = (t / d.tiles_x) * kT;
  tx0 = (t % d.tiles_x) * kT;
}

// dst[c * kXP + i] = src at the kX x kX window whose corner is (y0, x0), zero
// outside the image.
__device__ void load_window(const float* __restrict__ src, const Dims& d,
                            int C, int b, int v, int y0, int x0, float* dst) {
  for (int i = threadIdx.x; i < C * kX * kX; i += blockDim.x) {
    const int c = i / (kX * kX), r = i % (kX * kX);
    const int y = y0 + r / kX, x = x0 + r % kX;
    float val = 0.f;
    if (y >= 0 && y < d.H && x >= 0 && x < d.W)
      val = __ldg(src + at(d, C, b, y, x, c, v));
    dst[c * kXP + r] = val;
  }
}

__device__ __forceinline__ bool inside(const Dims& d, int y, int x) {
  return y >= 0 && y < d.H && x >= 0 && x < d.W;
}

// Channels 4g .. 4g+3 of pixel q: relu(acc), or 0 outside the image.
__device__ __forceinline__ void store_relu4(float* dst, int g, int q, int F,
                                            bool in_image, float4 acc) {
  const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = 4 * g + j;
    if (f < F) dst[f * kQP + q] = in_image ? fmaxf(v[j], 0.f) : 0.f;
  }
}

// In place: buf = (buf > 0) ? acc : 0, the ReLU's gradient gate.
__device__ __forceinline__ void gate4(float* buf, int g, int q, int F,
                                      float4 acc) {
  const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = 4 * g + j;
    if (f < F) {
      float* p = buf + f * kQP + q;
      *p = *p > 0.f ? v[j] : 0.f;
    }
  }
}

// Shared-memory copies of one head's W1 as [(c*9 + tap) * Fp + f], W2 as
// [k * Fp + f] and the biases b1, b2 (zero-padded to Fp).
__device__ void load_w1_w2(const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2, const Dims& d,
                           int head, float* w1s, float* w2t, float* b1s,
                           float* b2s) {
  const int F = d.F, Fp = d.Fp;
  const float* w1h = w1 + (int64_t)head * F * d.Cin * 9;
  const float* w2h = w2 + (int64_t)head * F * F;
  for (int i = threadIdx.x; i < d.Cin * 9 * Fp; i += blockDim.x) {
    const int f = i % Fp, ct = i / Fp;
    w1s[i] = f < F ? __ldg(w1h + f * d.Cin * 9 + ct) : 0.f;
  }
  for (int i = threadIdx.x; i < F * Fp; i += blockDim.x) {
    const int f = i % Fp, k = i / Fp;
    w2t[i] = f < F ? __ldg(w2h + f * F + k) : 0.f;
  }
  for (int i = threadIdx.x; i < Fp; i += blockDim.x) {
    b1s[i] = i < F ? __ldg(b1 + (int64_t)head * F + i) : 0.f;
    b2s[i] = i < F ? __ldg(b2 + (int64_t)head * F + i) : 0.f;
  }
}

// h1 = relu(conv3x3(x) + b1) on Q, whose corner is image pixel (y0, x0).
__device__ void layer1(const float* xs, const float* w1s, const float* b1s,
                       const Dims& d, int y0, int x0, float* h1) {
  const int groups = d.Fp / 4;
  for (int i = threadIdx.x; i < groups * kQ * kQ; i += blockDim.x) {
    const int g = i / (kQ * kQ), q = i % (kQ * kQ);
    const int qy = q / kQ, qx = q % kQ;
    float4 acc = ld4(b1s + 4 * g);
    for (int c = 0; c < d.Cin; ++c) {
      const float* xc = xs + c * kXP + qy * kX + qx;
      const float* wc = w1s + c * 9 * d.Fp + 4 * g;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          fma4(acc, xc[ky * kX + kx], ld4(wc + (ky * 3 + kx) * d.Fp));
    }
    store_relu4(h1, g, q, d.F, inside(d, y0 + qy, x0 + qx), acc);
  }
}

// h2 = relu(W2 h1 + b2) on Q.
__device__ void layer2(const float* h1, const float* w2t, const float* b2s,
                       const Dims& d, int y0, int x0, float* h2) {
  const int groups = d.Fp / 4;
  for (int i = threadIdx.x; i < groups * kQ * kQ; i += blockDim.x) {
    const int g = i / (kQ * kQ), q = i % (kQ * kQ);
    float4 acc = ld4(b2s + 4 * g);
    const float* wg = w2t + 4 * g;
#pragma unroll 4
    for (int k = 0; k < d.F; ++k) fma4(acc, h1[k * kQP + q], ld4(wg + k * d.Fp));
    store_relu4(h2, g, q, d.F, inside(d, y0 + q / kQ, x0 + q % kQ), acc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gat_mapping_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ out,
                       Dims d) {
  extern __shared__ float4 smem4[];
  const int F = d.F, Fp = d.Fp, Cout = d.Cout, head = blockIdx.y;
  float* w1s = reinterpret_cast<float*>(smem4);  // Cin * 9 * Fp
  float* w2t = w1s + d.Cin * 9 * Fp;             // F * Fp
  float* b1s = w2t + F * Fp;                     // Fp
  float* b2s = b1s + Fp;                         // Fp
  float* w3f = b2s + Fp;                         // [(f*9 + tap) * Cout + co]
  float* b3s = w3f + F * 9 * Cout;               // Cout
  float* xs = b3s + Cout;                        // Cin * kXP
  float* h1 = xs + d.Cin * kXP;                  // F * kQP
  float* h2 = h1 + F * kQP;                      // F * kQP
  float* red = h2 + F * kQP;                     // kSplit * Cout * kTT

  load_w1_w2(w1, b1, w2, b2, d, head, w1s, w2t, b1s, b2s);
  const float* w3h = w3 + (int64_t)head * Cout * F * 9;
  for (int i = threadIdx.x; i < F * 9 * Cout; i += blockDim.x) {
    const int co = i % Cout, ft = i / Cout;  // ft = f * 9 + tap
    w3f[i] = __ldg(w3h + co * F * 9 + ft);
  }
  for (int i = threadIdx.x; i < Cout; i += blockDim.x)
    b3s[i] = __ldg(b3 + (int64_t)head * Cout + i);
  float* outh = out + (int64_t)head * d.B * d.H * d.W * Cout * d.V;

  for (int j = blockIdx.x; j < d.jobs; j += gridDim.x) {
    int b, v, ty0, tx0;
    decode(d, j, b, v, ty0, tx0);
    __syncthreads();  // the weights are in; the last job is done with xs, red
    load_window(x, d, d.Cin, b, v, ty0 - 2, tx0 - 2, xs);
    __syncthreads();
    layer1(xs, w1s, b1s, d, ty0 - 1, tx0 - 1, h1);
    __syncthreads();
    layer2(h1, w2t, b2s, d, ty0 - 1, tx0 - 1, h2);
    __syncthreads();
    // conv3 on the tile, F split in kSplit parts summed below in order
    for (int i = threadIdx.x; i < kSplit * kTT; i += blockDim.x) {
      const int s = i / kTT, p = i % kTT, py = p / kT, px = p % kT;
      float acc[kMaxC];
#pragma unroll
      for (int co = 0; co < kMaxC; ++co) acc[co] = 0.f;
      for (int f = s * F / kSplit; f < (s + 1) * F / kSplit; ++f) {
        const float* hf = h2 + f * kQP + py * kQ + px;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float a = hf[(tap / 3) * kQ + tap % 3];
          const float* wt = w3f + (f * 9 + tap) * Cout;
#pragma unroll
          for (int co = 0; co < kMaxC; ++co)
            if (co < Cout) acc[co] = fmaf(a, wt[co], acc[co]);
        }
      }
#pragma unroll
      for (int co = 0; co < kMaxC; ++co)
        if (co < Cout) red[(s * Cout + co) * kTT + p] = acc[co];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Cout * kTT; i += blockDim.x) {
      const int co = i / kTT, p = i % kTT;
      const int y = ty0 + p / kT, xx = tx0 + p % kT;
      if (y >= d.H || xx >= d.W) continue;
      float o = b3s[co];
#pragma unroll
      for (int s = 0; s < kSplit; ++s) o += red[(s * Cout + co) * kTT + p];
      outh[at(d, Cout, b, y, xx, co, v)] = o;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gat_mapping_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ w3, float* __restrict__ dx,
                       float* __restrict__ partials, Dims d, int need_dx) {
  extern __shared__ float4 smem4[];
  const int F = d.F, Fp = d.Fp, Cin = d.Cin, Cout = d.Cout, head = blockIdx.y;
  const int E = grad_floats(Cin, F, Cout);
  const int o_db1 = F * Cin * 9, o_dw2 = o_db1 + F, o_db2 = o_dw2 + F * F;
  const int o_dw3 = o_db2 + F, o_db3 = o_dw3 + Cout * F * 9;
  float* w1s = reinterpret_cast<float*>(smem4);  // Cin * 9 * Fp
  float* w2t = w1s + Cin * 9 * Fp;               // [k * Fp + f]
  float* w2b = w2t + F * Fp;                     // [f * Fp + k]
  float* b1s = w2b + F * Fp;                     // Fp
  float* b2s = b1s + Fp;                         // Fp
  float* w3b = b2s + Fp;                         // [(co*9 + tap) * Fp + f]
  float* xs = w3b + Cout * 9 * Fp;               // Cin * kXP
  float* gs = xs + Cin * kXP;                    // Cout * kXP
  float* h1 = gs + Cout * kXP;                   // F * kQP: h1, then da1
  float* h2 = h1 + F * kQP;                      // F * kQP: h2, then da2
  float* acc = h2 + F * kQP;                     // E: this block's sums
  float* red = acc + E;                          // kSplit * Cin * kTT

  load_w1_w2(w1, b1, w2, b2, d, head, w1s, w2t, b1s, b2s);
  const float* w2h = w2 + (int64_t)head * F * F;
  for (int i = threadIdx.x; i < F * Fp; i += blockDim.x) {
    const int k = i % Fp, f = i / Fp;
    w2b[i] = k < F ? __ldg(w2h + f * F + k) : 0.f;
  }
  const float* w3h = w3 + (int64_t)head * Cout * F * 9;
  for (int i = threadIdx.x; i < Cout * 9 * Fp; i += blockDim.x) {
    const int f = i % Fp, ct = i / Fp, co = ct / 9, tap = ct % 9;
    w3b[i] = f < F ? __ldg(w3h + (co * F + f) * 9 + tap) : 0.f;
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) acc[i] = 0.f;
  const int64_t image_floats = (int64_t)d.B * d.H * d.W * d.V;
  const float* gh = g + (int64_t)head * image_floats * Cout;
  float* dxh = dx + (need_dx && d.NH > 1 ? (int64_t)head * image_floats * Cin : 0);
  // the pixels where da2 and da1 are needed: Q for dx, else the tile
  const int rn = need_dx ? kQ : kT, roff = need_dx ? 0 : 1;
  const int groups = Fp / 4;

  for (int j = blockIdx.x; j < d.jobs; j += gridDim.x) {
    int b, v, ty0, tx0;
    decode(d, j, b, v, ty0, tx0);
    __syncthreads();  // the weights are in; the last job is done with smem
    load_window(x, d, Cin, b, v, ty0 - 2, tx0 - 2, xs);
    load_window(gh, d, Cout, b, v, ty0 - 2, tx0 - 2, gs);
    __syncthreads();
    layer1(xs, w1s, b1s, d, ty0 - 1, tx0 - 1, h1);
    __syncthreads();
    layer2(h1, w2t, b2s, d, ty0 - 1, tx0 - 1, h2);
    __syncthreads();

    // dW3[co, f, ky, kx] += sum_p g[co, p] h2[f, p + (ky-1, kx-1)]; db3
    for (int i = threadIdx.x; i < F * 3 + Cout; i += blockDim.x) {
      if (i < F * 3) {
        const int f = i / 3, ky = i % 3;
        float s[kMaxC][3];
#pragma unroll
        for (int co = 0; co < kMaxC; ++co) s[co][0] = s[co][1] = s[co][2] = 0.f;
        for (int py = 0; py < kT; ++py) {
          for (int px = 0; px < kT; ++px) {
            const float* hr = h2 + f * kQP + (py + ky) * kQ + px;
            const float e0 = hr[0], e1 = hr[1], e2 = hr[2];
            const float* gp = gs + (py + 2) * kX + px + 2;
#pragma unroll
            for (int co = 0; co < kMaxC; ++co) {
              if (co < Cout) {
                const float gv = gp[co * kXP];
                s[co][0] = fmaf(gv, e0, s[co][0]);
                s[co][1] = fmaf(gv, e1, s[co][1]);
                s[co][2] = fmaf(gv, e2, s[co][2]);
              }
            }
          }
        }
#pragma unroll
        for (int co = 0; co < kMaxC; ++co)
          if (co < Cout)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[o_dw3 + ((co * F + f) * 3 + ky) * 3 + kx] += s[co][kx];
      } else {
        const int co = i - F * 3;
        float s = 0.f;
        for (int p = 0; p < kTT; ++p)
          s += gs[co * kXP + (p / kT + 2) * kX + p % kT + 2];
        acc[o_db3 + co] += s;
      }
    }
    __syncthreads();

    // da2 = (h2 > 0) * sum_{co, tap} g[co, p - (ky-1, kx-1)] W3[co, f, tap]
    for (int i = threadIdx.x; i < groups * rn * rn; i += blockDim.x) {
      const int gr = i / (rn * rn), r = i % (rn * rn);
      const int qy = r / rn + roff, qx = r % rn + roff;
      float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int co = 0; co < Cout; ++co) {
        const float* gc = gs + co * kXP + (qy + 2) * kX + qx + 2;
        const float* wc = w3b + co * 9 * Fp + 4 * gr;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            fma4(a4, gc[-ky * kX - kx], ld4(wc + (ky * 3 + kx) * Fp));
      }
      gate4(h2, gr, qy * kQ + qx, F, a4);
    }
    __syncthreads();

    // dW2[f, k] += sum_p da2[f, p] h1[k, p] in 4x4 register tiles; db2
    for (int i = threadIdx.x; i < groups * groups + F; i += blockDim.x) {
      if (i < groups * groups) {
        const int fg = i / groups, kg = i % groups;
        const float* ar[4];
        const float* br[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          ar[jj] = h2 + min(4 * fg + jj, F - 1) * kQP;
          br[jj] = h1 + min(4 * kg + jj, F - 1) * kQP;
        }
        float s[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int ll = 0; ll < 4; ++ll) s[jj][ll] = 0.f;
        for (int p = 0; p < kTT; ++p) {
          const int q = (p / kT + 1) * kQ + p % kT + 1;
          float av[4], bv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            av[jj] = ar[jj][q];
            bv[jj] = br[jj][q];
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int ll = 0; ll < 4; ++ll) s[jj][ll] = fmaf(av[jj], bv[ll], s[jj][ll]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int ll = 0; ll < 4; ++ll) {
            const int f = 4 * fg + jj, k = 4 * kg + ll;
            if (f < F && k < F) acc[o_dw2 + f * F + k] += s[jj][ll];
          }
      } else {
        const int f = i - groups * groups;
        float s = 0.f;
        for (int p = 0; p < kTT; ++p)
          s += h2[f * kQP + (p / kT + 1) * kQ + p % kT + 1];
        acc[o_db2 + f] += s;
      }
    }
    __syncthreads();

    // da1 = (h1 > 0) * sum_f da2[f, p] W2[f, k]
    for (int i = threadIdx.x; i < groups * rn * rn; i += blockDim.x) {
      const int gr = i / (rn * rn), r = i % (rn * rn);
      const int q = (r / rn + roff) * kQ + r % rn + roff;
      float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* wg = w2b + 4 * gr;
#pragma unroll 4
      for (int f = 0; f < F; ++f) fma4(a4, h2[f * kQP + q], ld4(wg + f * Fp));
      gate4(h1, gr, q, F, a4);
    }
    __syncthreads();

    // dW1[f, c, ky, kx] += sum_p da1[f, p] x[c, p + (ky-1, kx-1)]; db1
    for (int i = threadIdx.x; i < groups * Cin * 3 + F; i += blockDim.x) {
      if (i < groups * Cin * 3) {
        const int fg = i / (Cin * 3), r = i % (Cin * 3), c = r / 3, ky = r % 3;
        const float* ar[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) ar[jj] = h1 + min(4 * fg + jj, F - 1) * kQP;
        float s[4][3];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = 0.f;
        for (int py = 0; py < kT; ++py) {
          for (int px = 0; px < kT; ++px) {
            const int q = (py + 1) * kQ + px + 1;
            const float* xr = xs + c * kXP + (py + 1 + ky) * kX + px + 1;
            const float x0 = xr[0], x1 = xr[1], x2 = xr[2];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float a = ar[jj][q];
              s[jj][0] = fmaf(a, x0, s[jj][0]);
              s[jj][1] = fmaf(a, x1, s[jj][1]);
              s[jj][2] = fmaf(a, x2, s[jj][2]);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int f = 4 * fg + jj;
          if (f < F)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[((f * Cin + c) * 3 + ky) * 3 + kx] += s[jj][kx];
        }
      } else {
        const int f = i - groups * Cin * 3;
        float s = 0.f;
        for (int p = 0; p < kTT; ++p)
          s += h1[f * kQP + (p / kT + 1) * kQ + p % kT + 1];
        acc[o_db1 + f] += s;
      }
    }

    if (!need_dx) continue;
    // dx[c, p] = sum_{f, tap} da1[f, p - (ky-1, kx-1)] W1[f, c, tap], F split
    // in kSplit parts summed below in order
    for (int i = threadIdx.x; i < kSplit * kTT; i += blockDim.x) {
      const int s = i / kTT, p = i % kTT, py = p / kT, px = p % kT;
      float a[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) a[c] = 0.f;
      for (int f = s * F / kSplit; f < (s + 1) * F / kSplit; ++f) {
        const float* hf = h1 + f * kQP + (py + 2) * kQ + px + 2;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float dv = hf[-(tap / 3) * kQ - tap % 3];
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < Cin) a[c] = fmaf(dv, w1s[(c * 9 + tap) * Fp + f], a[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < Cin) red[(s * Cin + c) * kTT + p] = a[c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Cin * kTT; i += blockDim.x) {
      const int c = i / kTT, p = i % kTT;
      const int y = ty0 + p / kT, xx = tx0 + p % kT;
      if (y >= d.H || xx >= d.W) continue;
      float o = 0.f;
#pragma unroll
      for (int s = 0; s < kSplit; ++s) o += red[(s * Cin + c) * kTT + p];
      dxh[at(d, Cin, b, y, xx, c, v)] = o;
    }
  }
  __syncthreads();
  float* part = partials + ((int64_t)head * gridDim.x + blockIdx.x) * E;
  for (int i = threadIdx.x; i < E; i += blockDim.x) part[i] = acc[i];
}

// Weight and bias gradients: the sum of each entry's G partials, in order.
__global__ void gat_mapping_reduce_kernel(const float* __restrict__ partials,
                                          int G, Dims d, float* dw1, float* db1,
                                          float* dw2, float* db2, float* dw3,
                                          float* db3) {
  const int F = d.F, Cin = d.Cin, Cout = d.Cout;
  const int E = grad_floats(Cin, F, Cout);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)d.NH * E) return;
  const int head = (int)(i / E), e = (int)(i % E);
  const float* p = partials + (int64_t)head * G * E + e;
  float s = 0.f;
  for (int k = 0; k < G; ++k) s += p[(int64_t)k * E];
  const int n_dw1 = F * Cin * 9, n_dw3 = Cout * F * 9;
  int r = e;
  if (r < n_dw1) { dw1[(int64_t)head * n_dw1 + r] = s; return; }
  r -= n_dw1;
  if (r < F) { db1[(int64_t)head * F + r] = s; return; }
  r -= F;
  if (r < F * F) { dw2[(int64_t)head * F * F + r] = s; return; }
  r -= F * F;
  if (r < F) { db2[(int64_t)head * F + r] = s; return; }
  r -= F;
  if (r < n_dw3) { dw3[(int64_t)head * n_dw3 + r] = s; return; }
  r -= n_dw3;
  db3[(int64_t)head * Cout + r] = s;
}

// dst[i] = sum over heads h, in order, of src[h * n + i].
__global__ void sum_heads_kernel(const float* __restrict__ src, int NH,
                                 int64_t n, float* __restrict__ dst) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int h = 0; h < NH; ++h) s += src[(int64_t)h * n + i];
  dst[i] = s;
}

int64_t fwd_smem_bytes(int Cin, int F, int Cout) {
  const int Fp = pad4(F);
  return 4 * ((int64_t)Cin * 9 * Fp + F * Fp + 2 * Fp + F * 9 * Cout + Cout +
              Cin * kXP + 2 * F * kQP + kSplit * Cout * kTT);
}

int64_t bwd_smem_bytes(int Cin, int F, int Cout) {
  const int Fp = pad4(F);
  return 4 * ((int64_t)Cin * 9 * Fp + 2 * F * Fp + 2 * Fp + Cout * 9 * Fp +
              (Cin + Cout) * kXP + 2 * F * kQP + grad_floats(Cin, F, Cout) +
              kSplit * Cin * kTT);
}

// Fills d; returns 0, or cudaErrorInvalidValue for shapes the kernels refuse.
int make_dims(int NH, int B, int V, int H, int W, int Cin, int F, int Cout,
              int blocks, Dims& d) {
  if (NH < 1 || B < 1 || V < 1 || H < 1 || W < 1 || F < 1 || blocks < 1 ||
      Cin < 1 || Cin > kMaxC || Cout < 1 || Cout > kMaxC || NH > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  const int64_t jobs = (int64_t)B * V * tiles_x * tiles_y;
  if (jobs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  d = Dims{NH, B, V, H, W, Cin, F, Cout, pad4(F), (int)tiles_x,
           (int)(tiles_x * tiles_y), (int)jobs};
  return 0;
}

}  // namespace

// Shared memory a block of the forward (backward = 0) or backward (1) kernel
// needs at these widths; the kernels refuse more than 232,448 bytes.
extern "C" long long gat_mapping_smem_bytes(int Cin, int F, int Cout,
                                            int backward) {
  return backward ? bwd_smem_bytes(Cin, F, Cout) : fwd_smem_bytes(Cin, F, Cout);
}

// x: (B, H, W, Cin, V); w1 (NH, F, Cin, 3, 3), b1 (NH, F), w2 (NH, F, F, 1, 1),
// b2 (NH, F), w3 (NH, Cout, F, 3, 3), b3 (NH, Cout); out (NH, B, H, W, Cout, V).
// All f32, contiguous. `blocks` is G, the blocks a head. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gat_mapping_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, int NH, int B, int V,
                               int H, int W, int Cin, int F, int Cout,
                               int blocks, void* stream) {
  Dims d;
  if (int rc = make_dims(NH, B, V, H, W, Cin, F, Cout, blocks, d)) return rc;
  const int64_t smem = fwd_smem_bytes(Cin, F, Cout);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gat_mapping_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)NH);
  gat_mapping_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), d);
  return (int)cudaGetLastError();
}

// g: (NH, B, H, W, Cout, V), the gradient of out. Writes dw1 .. db3 (shaped as
// the weights) and, when need_dx, dx (B, H, W, Cin, V) summed over heads.
// Scratch: partials (NH * blocks * E floats, E = one head's parameter count)
// and, when need_dx and NH > 1, dx_heads (NH times dx). Returns
// cudaGetLastError() after the last launch (0 on success).
extern "C" int gat_mapping_bwd(const void* x, const void* g, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* w3, void* dx, void* dx_heads,
                               void* partials, void* dw1, void* db1, void* dw2,
                               void* db2, void* dw3, void* db3, int NH, int B,
                               int V, int H, int W, int Cin, int F, int Cout,
                               int blocks, int need_dx, void* stream) {
  Dims d;
  if (int rc = make_dims(NH, B, V, H, W, Cin, F, Cout, blocks, d)) return rc;
  const int64_t smem = bwd_smem_bytes(Cin, F, Cout);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gat_mapping_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dx_dst = static_cast<float*>(need_dx && NH > 1 ? dx_heads : dx);
  const dim3 grid((unsigned)blocks, (unsigned)NH);
  gat_mapping_bwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), dx_dst, static_cast<float*>(partials), d,
      need_dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t entries = (int64_t)NH * grad_floats(Cin, F, Cout);
  gat_mapping_reduce_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), blocks, d, static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
      static_cast<float*>(dw3), static_cast<float*>(db3));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (need_dx && NH > 1) {
    const int64_t n = (int64_t)B * H * W * Cin * V;
    sum_heads_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(dx_heads), NH, n, static_cast<float*>(dx));
  }
  return (int)cudaGetLastError();
}
