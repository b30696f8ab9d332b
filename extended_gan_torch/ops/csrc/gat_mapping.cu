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
// out, far above the card's flop:byte balance: at GAT3D's hidden block (3
// heads, 80x80, batch 32, V = 6) the bound is 1.1889 ms at the H100 SXM's
// 67 TFLOP/s f32 (its 700 W rating). Exact f32 is the contract (the TPU
// kernel runs Precision.HIGHEST), so every product is an f32 FMA on the CUDA
// cores; the tensor cores' TF32 would not match the plain version.
//
// Forward. The TPU kernel keeps a whole image's 74-wide intermediates in
// VMEM; one 80x80 intermediate is 1.9 MB here, against 227 KB of shared
// memory a block. So each image is cut into 16x16 output tiles (kFT): h1 and
// h2 are computed on the 18x18 neighbourhood (Q, 324 pixels) and x is staged
// on 20x20, a halo of 324 / 256 = 1.27x the work of the first two layers.
// One buffer of Fp x 324 floats (Fp = F padded to 80 at F = 74; 104 KB)
// holds h1, then h2 over it: layer 2 keeps its results in registers until
// every thread has read h1. With the weights and two x windows a block takes
// 164 KB: one block of 384 threads an SM.
//
// Register tiles. In layers 1 and 2 a thread owns 4 (or 3) pixels x 20
// channels; each step of the sum (a tap and input channel, or an input
// channel of h1) loads 4 scalars of x or h1, from pixels 96 apart so that a
// warp's lanes read consecutive words, and five 16-byte weight vectors that
// the whole warp shares (a broadcast), for 80 FMAs, where the first kernel
// issued 2 loads for 4. An SM issues FMAs from four sub-partitions, one warp
// instruction a clock each, and a sub-partition holds warps w, w + 4, ...:
// 324 pixels x 80 channels do not split evenly over 128-thread multiples,
// so each sub-partition gets two warps of 4-pixel tiles and one of 3 (352
// pixel slots for 324 pixels), the same work on every sub-partition. Layer 3
// (1,024 outputs a tile, 666 products each) splits the sum over F in 8
// parts by lane: a warp's 32 lanes are 4 adjacent columns x 8 parts, each
// lane owns a column of 8 output pixels x all Cout channels and, per
// (channel, kx), loads 10 h2 values and one 16-byte W3 vector a tap for 96
// FMAs. The h pitch of 324 words is 4 modulo 32, so those lanes read 32
// distinct banks. Warp shuffles add the 8 parts as a reduce-scatter (28
// shuffles, in a fixed order) that leaves lane `part` with output row
// `part`: no second pass through shared memory. Every output is written
// once, by one lane, with no atomics.
//
// Overlapped loads. Layer 3 runs on warps 0-7 (two a sub-partition); warps
// 8-11 meanwhile copy the next job's x window with cp.async (4-byte copies,
// zero-filled outside the image) into the second of two buffers, so the
// copy never waits in a job's path. x is read in GAT3D's (B, H, W, Cin, V)
// layout at stride V and staged channel-major. One block per SM and
// head-slice: grid (G, NH); the block loads its head's weights into shared
// memory once and walks the jobs (image, tile) blockIdx.x, blockIdx.x + G,
// ... in order.
//
// What is left (python -m extended_gan_torch.ops.k2_probe times each phase
// with clock64 and each layer's loop by removing it): the layer 1 and 2
// loops issue FMAs at about 70% of the pipe's rate. A register-only stream
// of this tile's FMAs runs at 93% of the f32 peak when each pixel value
// stays put across 20 FMAs and at 72% when each weight does, because an FMA
// whose two fresh operands share a register bank takes a second cycle; the
// weights arrive in aligned register quads, and ptxas pairs many of them
// with accumulators of the same bank. Layer 3's loop runs at about 97%.
// The computed work is 1.3x the bound's (halo, the 352 pixel slots for 324,
// F padded to 80); the h2 store and the wait for the window take 4% of a
// job's clocks. 20x20 images take four 16x16 tiles (2.6x the image's work).
// F is at most 80; at Cout > 4 (CG = 2) the build spills. All on an NVIDIA
// H100 80GB HBM3, 700 W.
//
// Backward (10x10 output tiles, kT): h1 and h2 on its 12x12 neighbourhood Q
// in shared memory (channel-major, odd pitch 145: a warp reading consecutive
// pixels of one channel, or one pixel of consecutive channels, hits distinct
// banks), and x and g on 14x14. SAME padding of the intermediates, in both
// kernels: h1 and h2 are zeroed at every Q pixel outside the image, as the
// TPU kernel masks them, which also zeroes their ReLU gates there.
//
// Backward, per job, each phase between two barriers: h1, then h2, on Q;
// dW3 += g x h2 over the tile and db3; da2 from g on Q, gated by h2 > 0,
// over h2; dW2 += da2 x h1 over the tile and db2; da1 from da2 on Q, gated
// by h1 > 0, over h1; dW1 += da1 x x over the tile and db1, and dx on the
// tile beside it when it is wanted. The channel products (h1, h2, da2, da1)
// run on register tiles of 6 Q pixels x 8 channels (warps 0-7), dW2 on
// 8 x 8 tiles of (f, k), dW3 and dW1 on 4 channels x 4 x 3 taps, each with
// the tile's pixel sum split over 4 lanes and added back by shuffles in a
// fixed order; dx gives each warp a tile row and each lane a share of F,
// added by shuffles. The TPU kernel sums the weight gradients across its
// sequential grid cells; CUDA blocks run concurrently, so each block keeps
// its own sums in shared memory over its fixed list of jobs, writes them
// once as a partial (G partials a head, 10,956 floats each), and a second
// kernel adds the G partials of each entry in a fixed order. dx of several
// heads that read the same x is written per head and summed over heads, in
// order, by a third. No float atomics: the results are bit-identical from
// run to run.
//
// What bounds the backward: one 512-thread block an SM (it holds ~203 KB of
// shared memory, so 128 registers a thread), and every product reads both
// operands from shared memory, whose data path returns 128 bytes a clock:
// a tile feeds 3 to 6 FMAs per 4-byte value a lane loads. python -m
// extended_gan_torch.ops.k2_probe times each phase.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kT = 10;            // output tile side
constexpr int kQ = kT + 2;        // h1 / h2 neighbourhood side
constexpr int kX = kT + 4;        // x / g window side
constexpr int kTT = kT * kT;
constexpr int kQP = kQ * kQ + 1;  // channel pitches, odd
constexpr int kXP = kX * kX + 1;
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

// The forward's geometry: see the note at the top.
constexpr int kFT = 16;                // output tile side
constexpr int kFQ = kFT + 2;           // h1 / h2 neighbourhood side
constexpr int kFX = kFT + 4;           // x window side
constexpr int kFNQ = kFQ * kFQ;        // 324: also h's channel pitch, 4 mod 32
constexpr int kFNX = kFX * kFX;
constexpr int kWPS = 3;                // warps on each of an SM's 4 sub-partitions
constexpr int kFwdThreads = 128 * kWPS;
constexpr int kCh = 20;                // channels of a layer 1-2 tile
constexpr int kPG = 32 * kWPS;         // pixel groups: pixels pg + kPG * jj
constexpr int kPx = 4;                 // pixels of a tile in "big" warps
constexpr int kBig = 2;                // big warps a sub-partition; the rest kPx - 1
constexpr int kFAlign = 40;            // F padding: kCh- and kParts-divisible
constexpr int kMaxFwdF = 4 * kCh;      // 4 channel groups, one a sub-partition
constexpr int kParts = 8;              // layer 3's F split, by lane
constexpr int kRows = 8;               // layer 3: output rows of a lane
constexpr int kStrips = kFT / kRows * kFT;  // layer 3's columns of kRows pixels
constexpr int kL3Threads = kStrips * kParts;  // layer 3's lanes: warps 0-7
static_assert(kFNQ % 32 == 4, "layer 3's lanes read distinct banks");
static_assert(kPG * (kPx - 1) < kFNQ && kFNQ <= kPG * (kPx - 1) + 32 * kBig,
              "big and small warps cover Q");
static_assert(kFAlign % kCh == 0 && kFAlign % kParts == 0, "F padding");
static_assert(kL3Threads == 256 && kFT % kRows == 0 && kRows == kParts &&
              kParts == 8, "layer 3: lane `part` writes row `part`");
static_assert(kFwdThreads > kL3Threads, "the other warps copy the next window");

__device__ __forceinline__ void fwd_decode(const Dims& d, int j, int& b, int& v,
                                           int& ty0, int& tx0) {
  const int n = j / d.tiles, t = j % d.tiles;
  b = n / d.V;
  v = n % d.V;
  ty0 = (t / d.tiles_x) * kFT;
  tx0 = (t % d.tiles_x) * kFT;
}

// Starts the copy of job j's x window, channel-major (dst[c * kFNX + r]),
// whose corner is image pixel (ty0 - 2, tx0 - 2), by threads t of n; zero
// outside the image. Commits one cp.async group.
__device__ void fwd_load_window(const float* __restrict__ x, const Dims& d,
                                int j, float* dst, int t, int n) {
  int b, v, ty0, tx0;
  fwd_decode(d, j, b, v, ty0, tx0);
  for (int i = t; i < d.Cin * kFNX; i += n) {
    const int c = i / kFNX, r = i % kFNX;
    const int y = ty0 - 2 + r / kFX, xx = tx0 - 2 + r % kFX;
    const bool in = inside(d, y, xx);
    __pipeline_memcpy_async(dst + i, in ? x + at(d, d.Cin, b, y, xx, c, v) : x,
                            4, in ? 0 : 4);
  }
  __pipeline_commit();
}

// A thread's layer 1 or 2 tile: channels kCh cg .. kCh cg + kCh - 1 of the Q
// pixels pg + kPG * jj, jj < NP (kPx in big warps, kPx - 1 in the others,
// whose last row of accumulators idles).
struct FwdTile {
  float acc[kPx][kCh];

  // acc[jj][k] += a[jj] * w[k]: each a[jj] feeds kCh FMAs in a row
  template <int NP>
  __device__ __forceinline__ void fma(const float (&a)[kPx], const float (&w)[kCh]) {
#pragma unroll
    for (int jj = 0; jj < NP; ++jj)
#pragma unroll
      for (int k = 0; k < kCh; ++k) acc[jj][k] = fmaf(a[jj], w[k], acc[jj][k]);
  }

  // every accumulator at its channel's bias
  __device__ __forceinline__ void init(const float* bias, int cg) {
#pragma unroll
    for (int g = 0; g < kCh / 4; ++g) {
      const float4 bv = ld4(bias + kCh * cg + 4 * g);
#pragma unroll
      for (int jj = 0; jj < kPx; ++jj) {
        acc[jj][4 * g] = bv.x;
        acc[jj][4 * g + 1] = bv.y;
        acc[jj][4 * g + 2] = bv.z;
        acc[jj][4 * g + 3] = bv.w;
      }
    }
  }

  // h[f * kFNQ + q] = relu(acc), or 0 where Q pixel q lies outside the
  // image (Q's corner is image pixel (y0, x0))
  template <int NP>
  __device__ __forceinline__ void store(float* h, const Dims& d, int cg, int pg,
                                        int y0, int x0) const {
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) {
      const int q = pg + kPG * jj;
      if (q >= kFNQ) continue;  // past Q: slots of the last pixel group only
      const bool in = inside(d, y0 + q / kFQ, x0 + q % kFQ);
#pragma unroll
      for (int k = 0; k < kCh; ++k)
        h[(kCh * cg + k) * kFNQ + q] = in ? fmaxf(acc[jj][k], 0.f) : 0.f;
    }
  }
};

// The kCh weights at w (16-byte aligned).
__device__ __forceinline__ void fwd_weights(float (&wv)[kCh], const float* w) {
#pragma unroll
  for (int g = 0; g < kCh / 4; ++g) {
    const float4 v = ld4(w + 4 * g);
    wv[4 * g] = v.x;
    wv[4 * g + 1] = v.y;
    wv[4 * g + 2] = v.z;
    wv[4 * g + 3] = v.w;
  }
}

// h1 = relu(conv3x3(x) + b1) at the tile's pixels, an implicit product with
// K = 9 Cin over the x window xw; xo[jj] is pixel jj's offset in it.
template <int NP>
__device__ __forceinline__ void fwd_layer1(FwdTile& tile, const float* xw,
                                           const float* wc, const int (&xo)[kPx],
                                           int Cin, int Fp) {
  for (int c = 0; c < Cin; ++c) {
    const float* xc = xw + c * kFNX;
    const float* w = wc + c * 9 * Fp;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * kFX + tap % 3;
      float wv[kCh], a[kPx];
      fwd_weights(wv, w + tap * Fp);
#pragma unroll
      for (int jj = 0; jj < NP; ++jj) a[jj] = xc[xo[jj] + off];
      tile.fma<NP>(a, wv);
    }
  }
}

// h2 = relu(W2 h1 + b2) at the tile's pixels, Q pixels q[jj] of h1 in hs.
template <int NP>
__device__ __forceinline__ void fwd_layer2(FwdTile& tile, const float* hs,
                                           const int (&q)[kPx], const float* wg,
                                           int F, int Fp) {
#pragma unroll 2
  for (int k = 0; k < F; ++k) {
    float wv[kCh], a[kPx];
    fwd_weights(wv, wg + k * Fp);
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) a[jj] = hs[k * kFNQ + q[jj]];
    tile.fma<NP>(a, wv);
  }
}

// One level of layer 3's reduce-scatter: rows 2n and 2n + 1 of `in` pair up;
// this lane keeps the one whose index has bit `bit` and adds the partner
// lane's (lane ^ lanes) copy of it, sending the other: out[n] = kept sum.
template <int N, int C>
__device__ __forceinline__ void fwd_halve(const float (&in)[2 * N][C],
                                          float (&out)[N][C], int bit, int lanes) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float lo = in[2 * n][k], hi = in[2 * n + 1][k];
      const float send = bit ? lo : hi;
      out[n][k] = (bit ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, lanes);
    }
}

// CG groups of 4 output channels (Cout <= 4 * CG).
template <int CG>
__global__ void __launch_bounds__(kFwdThreads, 1)
gat_mapping_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ out,
                       Dims d) {
  extern __shared__ float4 smem4[];
  constexpr int Cp = 4 * CG;
  const int F = d.F, Fp = (d.F + kFAlign - 1) / kFAlign * kFAlign;
  const int Cin = d.Cin, Cout = d.Cout;
  const int head = blockIdx.y;
  float* w1s = reinterpret_cast<float*>(smem4);  // [(c*9 + tap) * Fp + f]
  float* w2s = w1s + Cin * 9 * Fp;               // [k * Fp + f]
  float* b1s = w2s + F * Fp;                     // Fp
  float* b2s = b1s + Fp;                         // Fp
  float* w3s = b2s + Fp;                         // [(f*9 + tap) * Cp + co]
  float* b3s = w3s + Fp * 9 * Cp;                // Cp
  float* xs = b3s + Cp;                          // 2 windows of Cin * kFNX
  float* hs = xs + 2 * Cin * kFNX;               // Fp * kFNQ: h1, then h2

  if (blockIdx.x < d.jobs)
    fwd_load_window(x, d, blockIdx.x, xs, threadIdx.x, kFwdThreads);
  const float* w1h = w1 + (int64_t)head * F * Cin * 9;
  for (int i = threadIdx.x; i < Cin * 9 * Fp; i += blockDim.x) {
    const int f = i % Fp, ct = i / Fp;
    w1s[i] = f < F ? __ldg(w1h + f * Cin * 9 + ct) : 0.f;
  }
  const float* w2h = w2 + (int64_t)head * F * F;
  for (int i = threadIdx.x; i < F * Fp; i += blockDim.x) {
    const int f = i % Fp, k = i / Fp;
    w2s[i] = f < F ? __ldg(w2h + f * F + k) : 0.f;
  }
  for (int i = threadIdx.x; i < Fp; i += blockDim.x) {
    b1s[i] = i < F ? __ldg(b1 + (int64_t)head * F + i) : 0.f;
    b2s[i] = i < F ? __ldg(b2 + (int64_t)head * F + i) : 0.f;
  }
  const float* w3h = w3 + (int64_t)head * Cout * F * 9;
  for (int i = threadIdx.x; i < Fp * 9 * Cp; i += blockDim.x) {
    const int co = i % Cp, ft = i / Cp;  // ft = f * 9 + tap
    w3s[i] = co < Cout && ft < F * 9 ? __ldg(w3h + co * F * 9 + ft) : 0.f;
  }
  for (int i = threadIdx.x; i < Cp; i += blockDim.x)
    b3s[i] = i < Cout ? __ldg(b3 + (int64_t)head * Cout + i) : 0.f;
  float* outh = out + (int64_t)head * d.B * d.H * d.W * Cout * d.V;

  // layers 1 and 2: warp w owns channel group cg = w % 4 of pixel groups
  // 32 (w / 4) .. + 31, on sub-partition w % 4, which then carries kBig
  // warps of kPx pixels a lane and the rest of kPx - 1; groups past Fp idle
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = warp % 4, pg = 32 * (warp / 4) + lane;
  const bool l12 = cg < Fp / kCh, big = warp / 4 < kBig;
  // layer 3: lane = 4 * part + column; warp w owns output rows
  // kRows (w / (kFT/4)) .. + kRows - 1 of columns 4 (w % (kFT/4)) .. + 3
  const int part = lane / 4;
  const int r0 = kRows * (warp / (kFT / 4));
  const int col = 4 * (warp % (kFT / 4)) + lane % 4;
  int q[kPx], xo[kPx];  // Q pixel pg + kPG * jj (slots past Q read its last
                        // pixel), and its offset in the x window
#pragma unroll
  for (int jj = 0; jj < kPx; ++jj) {
    q[jj] = min(pg + kPG * jj, kFNQ - 1);
    xo[jj] = (q[jj] / kFQ) * kFX + q[jj] % kFQ;
  }

  int buf = 0;
  for (int j = blockIdx.x; j < d.jobs; j += gridDim.x, buf ^= 1) {
    __pipeline_wait_prior(0);  // this job's window is in
    __syncthreads();           // ... for every thread; layer 3 is done with hs
    int b, v, ty0, tx0;
    fwd_decode(d, j, b, v, ty0, tx0);
    FwdTile tile;

    // h1 = relu(conv3x3(x) + b1) on Q
    if (l12) {
      tile.init(b1s, cg);
      const float* xw = xs + buf * Cin * kFNX;
      if (big) {
        fwd_layer1<kPx>(tile, xw, w1s + kCh * cg, xo, Cin, Fp);
        tile.store<kPx>(hs, d, cg, pg, ty0 - 1, tx0 - 1);
      } else {
        fwd_layer1<kPx - 1>(tile, xw, w1s + kCh * cg, xo, Cin, Fp);
        tile.store<kPx - 1>(hs, d, cg, pg, ty0 - 1, tx0 - 1);
      }
    }
    __syncthreads();

    // h2 = relu(W2 h1 + b2) on Q, kept in registers until all of h1 is read
    if (l12) {
      tile.init(b2s, cg);
      if (big)
        fwd_layer2<kPx>(tile, hs, q, w2s + kCh * cg, F, Fp);
      else
        fwd_layer2<kPx - 1>(tile, hs, q, w2s + kCh * cg, F, Fp);
    }
    __syncthreads();
    if (l12) {
      if (big)
        tile.store<kPx>(hs, d, cg, pg, ty0 - 1, tx0 - 1);
      else
        tile.store<kPx - 1>(hs, d, cg, pg, ty0 - 1, tx0 - 1);
    }
    __syncthreads();

    // out = conv3x3(h2) + b3 on the tile: this lane's part of the sum over
    // channels f = kParts * i + part, for output rows r0 .. r0 + kRows - 1
    // at col, in warps 0-7: two on each sub-partition. Warps 8 and up copy
    // the next job's window meanwhile into the other buffer, whose last
    // reader (layer 1) is past three barriers.
    if (threadIdx.x >= kL3Threads) {
      if (j + (int)gridDim.x < d.jobs)
        fwd_load_window(x, d, j + gridDim.x, xs + (buf ^ 1) * Cin * kFNX,
                        threadIdx.x - kL3Threads, kFwdThreads - kL3Threads);
    } else {
      float o[kRows][Cp];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < Cp; ++k) o[r][k] = 0.f;
      for (int i = 0; i < Fp / kParts; ++i) {
        const int f = kParts * i + part;
        const float* hf = hs + f * kFNQ + r0 * kFQ + col;
        const float* wf = w3s + f * 9 * Cp;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float hv[kRows + 2];
#pragma unroll
          for (int rr = 0; rr < kRows + 2; ++rr) hv[rr] = hf[rr * kFQ + kx];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int g = 0; g < CG; ++g) {
              const float4 wv = ld4(wf + (ky * 3 + kx) * Cp + 4 * g);
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const float a = hv[r + ky];
                o[r][4 * g] = fmaf(a, wv.x, o[r][4 * g]);
                o[r][4 * g + 1] = fmaf(a, wv.y, o[r][4 * g + 1]);
                o[r][4 * g + 2] = fmaf(a, wv.z, o[r][4 * g + 2]);
                o[r][4 * g + 3] = fmaf(a, wv.w, o[r][4 * g + 3]);
              }
            }
        }
      }
      // the parts' sum, reduce-scattered: at each level (lanes 4, 8, 16
      // apart) a lane keeps the half of its rows whose bit matches its part
      // and adds its partner's copy of them, so it ends with row `part`
      // summed over the 8 parts, in a fixed order (28 shuffles, not 96)
      float o4[kRows / 2][Cp], o2[kRows / 4][Cp], row[1][Cp];
      fwd_halve<kRows / 2>(o, o4, part & 1, 4);
      fwd_halve<kRows / 4>(o4, o2, part >> 1 & 1, 8);
      fwd_halve<1>(o2, row, part >> 2, 16);
      // lane `part` writes output row r0 + part
      const int y = ty0 + r0 + part, xx = tx0 + col;
      if (y < d.H && xx < d.W) {
#pragma unroll
        for (int k = 0; k < Cp; ++k)
          if (k < Cout) outh[at(d, Cout, b, y, xx, k, v)] = row[0][k] + b3s[k];
      }
    }
  }
}

// The backward's phases are __noinline__ functions: each gets the whole
// register budget (128 a thread at 512 threads) for its own tiles. Inlined
// into the job loop, the loop's live state beside the largest tile (dW2's
// 64 accumulators and 16 operands) made ptxas spill.
//
// The backward's channel products (layers 1 and 2, da2, da1) on register
// tiles: thread t of warps 0-7 owns kPT Q pixels x kCT channels, pixels
// pl + kPL * jj of channels kCT * cg .. kCT * cg + 7 (cg = t / kPL, pl =
// t % kPL). A step of the sum loads kPT pixel values (consecutive pixels
// across the lanes) and two 16-byte weight vectors that the lanes of a
// channel group share, for 48 FMAs.
constexpr int kPT = 6;                 // pixels of a product tile
constexpr int kCT = 8;                 // channels of a product tile
constexpr int kPL = kQ * kQ / kPT;     // 24 pixel lanes a channel group
constexpr int kCG = 10;                // channel groups a pass (80 channels)
constexpr int kProdThreads = kCG * kPL;  // 240: warps 0-7 (7 half)
constexpr int kSideWarp = 8;           // warps 8-15 run dW3
static_assert(kPL * kPT == kQ * kQ && kPL % kQ == 0, "the tiles cover Q");
static_assert(kProdThreads <= 32 * kSideWarp, "products fit warps 0-7");

struct ProdTile {
  float a[kPT][kCT];
  int pl;        // pixels pl + kPL * jj (offsets 28 jj in a kX-wide window)
  int cg = -1;   // channel group, in each pass of kCG groups; -1 idles.
                 // Fp = 76 at F = 74 takes one pass, whose group 9
                 // computes four channels of padding from weight vectors
                 // that run into the next row

  __device__ explicit ProdTile(int t) : pl(t % kPL) {
    if (t < kProdThreads) cg = t / kPL;
  }

  __device__ __forceinline__ void init(const float* bias) {
#pragma unroll
    for (int k = 0; k < kCT; ++k) {
      const float b = bias ? bias[k] : 0.f;
#pragma unroll
      for (int jj = 0; jj < kPT; ++jj) a[jj][k] = b;
    }
  }

  // a[jj][k] += v[jj] * w[k], w 16-byte aligned
  __device__ __forceinline__ void fma(const float (&v)[kPT], const float* w) {
    const float4 w0 = ld4(w), w1 = ld4(w + 4);
    const float wv[kCT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj)
#pragma unroll
      for (int k = 0; k < kCT; ++k) a[jj][k] = fmaf(v[jj], wv[k], a[jj][k]);
  }

  // v[jj] = src[jj * step]: the tile's pixels at one tap
  template <int kStep>
  __device__ __forceinline__ static void gather(float (&v)[kPT],
                                                const float* src) {
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) v[jj] = src[jj * kStep];
  }

  // a += conv3x3(x; W1) at the pixels, channels of group c0
  __device__ void layer1(const float* xs, const float* w1s, const Dims& d,
                         int c0) {
    // Q pixel pl's window corner
    const float* xp = xs + (pl / kQ) * kX + pl % kQ;
    for (int c = 0; c < d.Cin; ++c) {
      const float* xc = xp + c * kXP;
      const float* wc = w1s + c * 9 * d.Fp + kCT * c0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float v[kPT];
        gather<kPL / kQ * kX>(v, xc + (tap / 3) * kX + tap % 3);
        fma(v, wc + tap * d.Fp);
      }
    }
  }

  // a += sum_i W[i, .] in[i, .] (w: [i * Fp + channel]): layer 2 (in h1,
  // w2t) and da1 (in da2, w2b)
  __device__ void product(const float* in, const float* w, const Dims& d,
                          int c0) {
    const float* wc = w + kCT * c0;
    const float* ip = in + pl;
#pragma unroll 2
    for (int i = 0; i < d.F; ++i) {
      float v[kPT];
      gather<kPL>(v, ip + i * kQP);
      fma(v, wc + i * d.Fp);
    }
  }

  // a += sum_{co, tap} g[co, q - (ky-1, kx-1)] W3[co, ., tap] (w3b)
  __device__ void da2(const float* gs, const float* w3b, const Dims& d,
                      int c0) {
    const float* gp = gs + (pl / kQ + 2) * kX + pl % kQ + 2;
    for (int co = 0; co < d.Cout; ++co) {
      const float* gc = gp + co * kXP;
      const float* wc = w3b + co * 9 * d.Fp + kCT * c0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float v[kPT];
        gather<kPL / kQ * kX>(v, gc - (tap / 3) * kX - tap % 3);
        fma(v, wc + tap * d.Fp);
      }
    }
  }

  // What the tile writes at h (channels of group c0, Q's corner at image
  // pixel (y0, x0)): kRelu, relu(a), or 0 at Q pixels outside the image;
  // kGate, (h > 0) ? a : 0 in place
  enum Mode { kRelu, kGate };
  template <Mode kMode>
  __device__ void store(float* h, const Dims& d, int c0, int y0, int x0) const {
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) {
      const int q = pl + kPL * jj;
      const bool in = inside(d, y0 + q / kQ, x0 + q % kQ);
#pragma unroll
      for (int k = 0; k < kCT; ++k) {
        const int f = kCT * c0 + k;
        if (f >= d.F) continue;
        float* p = h + f * kQP + q;
        if (kMode == kRelu)
          *p = in ? fmaxf(a[jj][k], 0.f) : 0.f;
        else
          *p = *p > 0.f ? a[jj][k] : 0.f;
      }
    }
  }
};

// h1 = relu(conv3x3(x) + b1) (kLayer 1) or h2 = relu(W2 h1 + b2) (kLayer 2)
// on Q, whose corner is image pixel (y0, x0), by warps 0-7
template <int kLayer>
__device__ __noinline__ void bwd_layer(const float* in, const float* w,
                                       const float* bias, const Dims& d, int y0,
                                       int x0, float* out) {
  ProdTile t(threadIdx.x);
  for (int c0 = t.cg; c0 >= 0 && kCT * c0 < d.Fp; c0 += kCG) {
    t.init(bias + kCT * c0);
    if (kLayer == 1)
      t.layer1(in, w, d, c0);
    else
      t.product(in, w, d, c0);
    t.store<ProdTile::kRelu>(out, d, c0, y0, x0);
  }
}

// da1 = (h1 > 0) * W2^T da2 in place of h1 on Q, by warps 0-7
__device__ __noinline__ void bwd_da1(const float* da2, const float* w2b,
                                     const Dims& d, float* h1) {
  ProdTile t(threadIdx.x);
  for (int c0 = t.cg; c0 >= 0 && kCT * c0 < d.Fp; c0 += kCG) {
    t.init(nullptr);
    t.product(da2, w2b, d, c0);
    t.store<ProdTile::kGate>(h1, d, c0, 0, 0);
  }
}

// dW3[co, f, ky, kx] += sum_p g[co, p] h2[f, p + (ky-1, kx-1)] over the
// tile's 100 pixels, by warps 8-15: a unit (channels 4 fg .. 4 fg + 3, one
// ky) is held by 4 lanes of a warp (8 units a warp), which sum 25 pixels
// each (part s = lane / 8 from pixel 25 s) into 4 channels x 4 co x 3 kx,
// loading 12 h2 and 4 g values a pixel for 48 FMAs, and add their parts by
// a reduce-scatter in a fixed order; lane s then writes co = 2 bit0 + bit1.
// Output channels go four at a time (Cout <= kMaxC).
__device__ __noinline__ void bwd_dw3(const float* h2, const float* gs,
                                     const Dims& d, float* dw3) {
  const int F = d.F, Cout = d.Cout, units = d.Fp / 4 * 3;
  const int w = threadIdx.x / 32 - kSideWarp, lane = threadIdx.x % 32;
  const int s = lane / 8, bit0 = (lane >> 3) & 1, bit1 = (lane >> 4) & 1;
  const int stride = 8 * (kThreads / 32 - kSideWarp);
  for (int u = 8 * w + lane % 8; u - lane % 8 < units; u += stride)
    for (int co0 = 0; co0 < Cout; co0 += 4) {
      const int fg = min(u, units - 1) / 3, ky = min(u, units - 1) % 3;
      // rows 4 fg .. 4 fg + 3 (those from F to Fp read the buffer that
      // follows, for sums that are dropped)
      const float* hb = h2 + 4 * fg * kQP + ky * kQ;
      float acc[16][3];  // [jj * 4 + co][kx]
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
      for (int m = 0; m < kTT / 4; ++m) {
        const int p = kTT / 4 * s + m, py = p / kT, px = p % kT;
        float gv[4];
#pragma unroll
        for (int co = 0; co < 4; ++co)
          gv[co] = co0 + co < Cout
                       ? gs[(co0 + co) * kXP + (py + 2) * kX + px + 2]
                       : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* e = hb + jj * kQP + py * kQ + px;
          const float e0 = e[0], e1 = e[1], e2 = e[2];
#pragma unroll
          for (int co = 0; co < 4; ++co) {
            acc[jj * 4 + co][0] = fmaf(gv[co], e0, acc[jj * 4 + co][0]);
            acc[jj * 4 + co][1] = fmaf(gv[co], e1, acc[jj * 4 + co][1]);
            acc[jj * 4 + co][2] = fmaf(gv[co], e2, acc[jj * 4 + co][2]);
          }
        }
      }
      float h8[8][3], h4[4][3];
      fwd_halve<8>(acc, h8, bit1, 16);
      fwd_halve<4>(h8, h4, bit0, 8);
      // row 4 n + 2 bit0 + bit1 of acc: channel 4 fg + n, co0 + 2 bit0 + bit1
      const int co = co0 + 2 * bit0 + bit1;
      if (u >= units || co >= Cout) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int f = 4 * fg + n;
        if (f < F)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            dw3[((co * F + f) * 3 + ky) * 3 + kx] += h4[n][kx];
      }
    }
}

// dW3 and db3 from h2 and g (warps 8-15, and the threads of warp 7 past
// the product tiles), then da2 = (h2 > 0) * sum_{co, tap} g[co, q - (ky-1,
// kx-1)] W3[co, f, tap] on Q over h2 (warps 0-7). Holding da2 in registers
// while dW3 reads h2 would overlap the two, but its 48 accumulators live
// across the barrier made the kernel spill.
__device__ __noinline__ void bwd_dw3_da2(float* h2, const float* gs,
                                         const float* w3b, const Dims& d,
                                         float* dw3, float* db3) {
  if (threadIdx.x / 32 >= kSideWarp) {
    bwd_dw3(h2, gs, d, dw3);
  } else if (threadIdx.x >= kProdThreads &&
             threadIdx.x - kProdThreads < d.Cout) {
    const int co = threadIdx.x - kProdThreads;
    float s = 0.f;
    for (int p = 0; p < kTT; ++p)
      s += gs[co * kXP + (p / kT + 2) * kX + p % kT + 2];
    db3[co] += s;
  }
  __syncthreads();  // dW3 is done with h2
  ProdTile t(threadIdx.x);
  for (int c0 = t.cg; c0 >= 0 && kCT * c0 < d.Fp; c0 += kCG) {
    t.init(nullptr);
    t.da2(gs, w3b, d, c0);
    t.store<ProdTile::kGate>(h2, d, c0, 0, 0);
  }
}

// dW2[f, k] += sum_p da2[f, p] h1[k, p] over the tile's 100 pixels, on 8 x 8
// register tiles f = f0 + fg + 10 jj, k = k0 + kg + 10 ll (fg, kg < 10, f0
// and k0 stepping by 80): a warp holds 8 tiles, each over 4 lanes that sum
// 25 pixels apiece (part s = lane / 8 from pixel 25 s), and adds the parts
// by a reduce-scatter of 48 shuffles in a fixed order. Warps 0-9 hold 2 fg
// x 4 kg (kg < 8), warps 10-12 4 fg x kg 8, 9: with the pixel blocks 25
// apart, a load's 16 or 32 addresses fall in distinct banks. The rows are
// 10 apart at every F, so a load's offset is an immediate; rows at F and
// past it, whose sums are dropped, read the buffers that follow (and the
// slack bwd_smem_bytes adds at small F). Warps 13-15 sum db2. Each (f, k)
// is written by one lane.
constexpr int kW2Stride = 10;
__device__ __noinline__ void bwd_dw2(const float* da2, const float* h1,
                                     const Dims& d, float* dw2, float* db2) {
  const int F = d.F;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = lane / 8, tl = lane % 8;
  if (w >= 13) {
    for (int f = threadIdx.x - 13 * 32; f < F; f += (kThreads / 32 - 13) * 32) {
      float sum = 0.f;
      for (int p = 0; p < kTT; ++p)
        sum += da2[f * kQP + (p / kT + 1) * kQ + p % kT + 1];
      db2[f] += sum;
    }
    return;
  }
  const int fg = w < 10 ? 2 * (w % 5) + tl / 4 : 4 * (w - 10) + tl / 2;
  const int kg = w < 10 ? 4 * (w / 5) + tl % 4 : 8 + tl % 2;
  // lanes past the 10 x 10 tiles (in warp 12) compute on row 0 and write
  // nothing: the shuffles need every lane of the warp
  const bool valid = fg < kW2Stride && kg < kW2Stride;
  const int bit0 = (lane >> 3) & 1, bit1 = (lane >> 4) & 1;
  for (int f0 = 0; f0 < F; f0 += 8 * kW2Stride)
    for (int k0 = 0; k0 < F; k0 += 8 * kW2Stride) {
      const float* ar = da2 + (valid ? f0 + fg : 0) * kQP;
      const float* br = h1 + (valid ? k0 + kg : 0) * kQP;
      float acc[8][8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int ll = 0; ll < 8; ++ll) acc[jj][ll] = 0.f;
#pragma unroll 1  // a pipelined next pixel's 16 loads would spill
      for (int m = 0; m < kTT / 4; ++m) {
        const int p = kTT / 4 * s + m, q = (p / kT + 1) * kQ + p % kT + 1;
        float av[8], bv[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          av[jj] = ar[jj * kW2Stride * kQP + q];
          bv[jj] = br[jj * kW2Stride * kQP + q];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int ll = 0; ll < 8; ++ll)
            acc[jj][ll] = fmaf(av[jj], bv[ll], acc[jj][ll]);
      }
      // the 4 parts, reduce-scattered by fwd_halve: lanes 16 apart, then 8
      // apart, leave this lane rows jj = 4 n + 2 bit0 + bit1 summed
      float h4[4][8], h2[2][8];
      fwd_halve<4>(acc, h4, bit1, 16);
      fwd_halve<2>(h4, h2, bit0, 8);
      if (!valid) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int f = f0 + fg + kW2Stride * (4 * n + 2 * bit0 + bit1);
#pragma unroll
        for (int ll = 0; ll < 8; ++ll) {
          const int k = k0 + kg + kW2Stride * ll;
          if (f < F && k < F) dw2[f * F + k] += h2[n][ll];
        }
      }
    }
}

// Shared-memory floats past the backward's buffers that dW2's rows can
// reach: its tiles span 80 rows from a multiple of 80, past h2's F rows.
__host__ __device__ inline int dw2_slack(int Cin, int F, int Cout) {
  const int rows = (F + 8 * kW2Stride - 1) / (8 * kW2Stride) * 8 * kW2Stride;
  const int over = (rows - F) * kQP - grad_floats(Cin, F, Cout);
  return over > 0 ? over : 0;
}

// dW1[f, c, ky, kx] += sum_p da1[f, p] x[c, p + (ky-1, kx-1)] over the
// tile's 100 pixels, and db1, by warps w0 .. w0 + nw - 1, units u_begin
// up to u_end (or the last) in turn: as dW3, a unit
// (channels fg + S jj, S = Fp / 4, jj < 4: strided, so that a load's
// addresses fall in distinct banks; one ky) is held by 4 lanes of a warp
// that sum 25 pixels each (from pixel 25 s) into 4 channels x 4 c x 3 kx
// (4 da1 and 12 x values a pixel for 48 FMAs) and reduce-scatter their
// parts; units of ky = 0 also sum da1 alone for db1. Rows of Fp past F read
// h2, for sums that are dropped. Input channels go four at a time.
__device__ __noinline__ void bwd_dw1(const float* da1, const float* xs,
                                     const Dims& d, float* dw1, float* db1,
                                     int w0, int nw, int u_begin, int u_end) {
  const int F = d.F, Cin = d.Cin, S = d.Fp / 4, units = min(S * 3, u_end);
  const int w = threadIdx.x / 32 - w0, lane = threadIdx.x % 32;
  const int s = lane / 8, bit0 = (lane >> 3) & 1, bit1 = (lane >> 4) & 1;
  for (int u = u_begin + 8 * w + lane % 8; u - lane % 8 < units; u += 8 * nw)
    for (int c0 = 0; c0 < Cin; c0 += 4) {
      const int fg = min(u, units - 1) / 3, ky = min(u, units - 1) % 3;
      const float* ab = da1 + fg * kQP;
      float acc[16][3];  // [jj * 4 + c][kx]
      float db[4][1];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) db[jj][0] = 0.f;
      for (int m = 0; m < kTT / 4; ++m) {
        const int p = kTT / 4 * s + m, py = p / kT, px = p % kT;
        float av[4], xv[4][3];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          av[jj] = ab[jj * S * kQP + (py + 1) * kQ + px + 1];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* xr = xs + (c0 + c) * kXP + (py + 1 + ky) * kX + px + 1;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            xv[c][kx] = c0 + c < Cin ? xr[kx] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          db[jj][0] += av[jj];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[jj * 4 + c][kx] =
                  fmaf(av[jj], xv[c][kx], acc[jj * 4 + c][kx]);
        }
      }
      // rows 4 n + 2 bit0 + bit1 of acc: channel fg + S n, c0 + 2 bit0 +
      // bit1; db row 2 bit0 + bit1: channel fg + S (2 bit0 + bit1)
      float h8[8][3], h4[4][3], d2[2][1], d1[1][1];
      fwd_halve<8>(acc, h8, bit1, 16);
      fwd_halve<4>(h8, h4, bit0, 8);
      fwd_halve<2>(db, d2, bit1, 16);
      fwd_halve<1>(d2, d1, bit0, 8);
      if (u >= units) continue;
      const int c = c0 + 2 * bit0 + bit1;
      if (c0 == 0 && ky == 0 && fg + S * (2 * bit0 + bit1) < F)
        db1[fg + S * (2 * bit0 + bit1)] += d1[0][0];
      if (c >= Cin) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int f = fg + S * n;
        if (f < F)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            dw1[((f * Cin + c) * 3 + ky) * 3 + kx] += h4[n][kx];
      }
    }
}

// dx[c, p] = sum_{f, tap} da1[f, p - (ky-1, kx-1)] W1[f, c, tap] on the
// tile, written to dxh (image b, v; corner (ty0, tx0)) by warps 0-9: warp
// py owns tile row py; lane l sums the channels f = l, l + 32, ... (rows
// 145 words apart: distinct banks), loading a 12-wide Q row of da1 a ky and
// W1's 36 weights of f for 360 FMAs, and the 32 lanes' sums are added by
// a reduce-scatter (5 values a lane) and a butterfly, in a fixed order;
// each output is written once. Input channels go four at a time.
constexpr int kDxWarps = kT;
__device__ __noinline__ void bwd_dx(const float* da1, const float* w1s,
                                    const Dims& d, float* dxh, int b, int v,
                                    int ty0, int tx0) {
  const int F = d.F, Fp = d.Fp, Cin = d.Cin;
  const int py = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;
  for (int c0 = 0; c0 < Cin; c0 += 4) {
    float o[4 * kT][1];  // [px * 4 + c]
#pragma unroll
    for (int r = 0; r < 4 * kT; ++r) o[r][0] = 0.f;
    for (int f = lane; f - lane < F; f += 32) {
      const bool fv = f < F;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // Q row py + 2 - ky holds the da1 that tile row py reads at ky
        const float* ur = da1 + f * kQP + (py + 2 - ky) * kQ;
        float u[kQ];
#pragma unroll
        for (int cx = 0; cx < kQ; ++cx) u[cx] = fv ? ur[cx] : 0.f;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float wv = fv && c0 + c < Cin
                                 ? w1s[((c0 + c) * 9 + ky * 3 + kx) * Fp + f]
                                 : 0.f;
#pragma unroll
            for (int px = 0; px < kT; ++px)
              o[px * 4 + c][0] = fmaf(u[px + 2 - kx], wv, o[px * 4 + c][0]);
          }
      }
    }
    // lane keeps rows 8 n + 4 b2 + 2 b3 + b4, then sums them over its quad
    float o20[2 * kT][1], o10[kT][1], o5[kT / 2][1];
    fwd_halve<2 * kT>(o, o20, b4, 16);
    fwd_halve<kT>(o20, o10, b3, 8);
    fwd_halve<kT / 2>(o10, o5, b2, 4);
#pragma unroll
    for (int n = 0; n < kT / 2; ++n) {
      o5[n][0] += __shfl_xor_sync(0xffffffffu, o5[n][0], 2);
      o5[n][0] += __shfl_xor_sync(0xffffffffu, o5[n][0], 1);
    }
    const int y = ty0 + py;
    if ((lane & 3) || y >= d.H) continue;
#pragma unroll
    for (int n = 0; n < kT / 2; ++n) {
      const int r = 8 * n + 4 * b2 + 2 * b3 + b4, px = r / 4, c = c0 + r % 4;
      if (c < Cin && tx0 + px < d.W)
        dxh[at(d, Cin, b, y, tx0 + px, c, v)] = o5[n][0];
    }
  }
}
static_assert(kDxWarps <= kThreads / 32 && 4 * kT % 8 == 0, "dx's warps");

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
  const int warp = threadIdx.x / 32;
  for (int j = blockIdx.x; j < d.jobs; j += gridDim.x) {
    int b, v, ty0, tx0;
    decode(d, j, b, v, ty0, tx0);
    __syncthreads();  // the weights are in; the last job is done with smem
    load_window(x, d, Cin, b, v, ty0 - 2, tx0 - 2, xs);
    load_window(gh, d, Cout, b, v, ty0 - 2, tx0 - 2, gs);
    __syncthreads();
    // h1 = relu(conv3x3(x) + b1), h2 = relu(W2 h1 + b2) on Q, whose corner
    // is image pixel (ty0 - 1, tx0 - 1)
    bwd_layer<1>(xs, w1s, b1s, d, ty0 - 1, tx0 - 1, h1);
    __syncthreads();
    bwd_layer<2>(h1, w2t, b2s, d, ty0 - 1, tx0 - 1, h2);
    __syncthreads();
    // dW3 += g x h2 over the tile, db3; then da2 on Q, in place of h2
    bwd_dw3_da2(h2, gs, w3b, d, acc + o_dw3, acc + o_db3);
    __syncthreads();
    bwd_dw2(h2, h1, d, acc + o_dw2, acc + o_db2);
    __syncthreads();
    // da1 = (h1 > 0) * sum_f da2[f, q] W2[f, k] on Q, in place of h1
    bwd_da1(h2, w2b, d, h1);
    __syncthreads();

    // dW1 += da1 x x over the tile and db1; beside them, when dx is wanted,
    // dx[c, p] = sum_{f, tap} da1[f, p - (ky-1, kx-1)] W1[f, c, tap]
    // (dW1's first units on the warps past dx's, the rest on dx's last two
    // warps after their rows: 57 units at F = 74)
    constexpr int kDw1Side = kThreads / 32 - kDxWarps;
    constexpr int kSideUnits = 8 * kDw1Side;
    if (!need_dx) {
      bwd_dw1(h1, xs, d, acc, acc + o_db1, 0, kThreads / 32, 0, INT_MAX);
    } else if (warp >= kDxWarps) {
      bwd_dw1(h1, xs, d, acc, acc + o_db1, kDxWarps, kDw1Side, 0, kSideUnits);
    } else {
      bwd_dx(h1, w1s, d, dxh, b, v, ty0, tx0);
      if (warp >= kDxWarps - 2)
        bwd_dw1(h1, xs, d, acc, acc + o_db1, kDxWarps - 2, 2, kSideUnits,
                INT_MAX);
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
  const int Fp = (F + kFAlign - 1) / kFAlign * kFAlign, Cp = pad4(Cout);
  return 4 * ((int64_t)Cin * 9 * Fp + F * Fp + 2 * Fp + Fp * 9 * Cp + Cp +
              2 * Cin * kFNX + Fp * kFNQ);
}

int64_t bwd_smem_bytes(int Cin, int F, int Cout) {
  const int Fp = pad4(F);
  return 4 * ((int64_t)Cin * 9 * Fp + 2 * F * Fp + 2 * Fp + Cout * 9 * Fp +
              (Cin + Cout) * kXP + 2 * F * kQP + grad_floats(Cin, F, Cout) +
              dw2_slack(Cin, F, Cout));
}

// The forward's jobs: (image, kFT x kFT tile) pairs. False if too many.
bool fwd_tiles(Dims& d) {
  const int64_t tiles_x = (d.W + kFT - 1) / kFT, tiles_y = (d.H + kFT - 1) / kFT;
  const int64_t jobs = (int64_t)d.B * d.V * tiles_x * tiles_y;
  if (jobs > 0x7fffffff) return false;
  d.tiles_x = (int)tiles_x;
  d.tiles = (int)(tiles_x * tiles_y);
  d.jobs = (int)jobs;
  return true;
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
// needs at these widths; the kernels refuse more than 232,448 bytes, and the
// forward a hidden width F above 80.
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
  if (F > kMaxFwdF || !fwd_tiles(d)) return (int)cudaErrorInvalidValue;
  const int64_t smem = fwd_smem_bytes(Cin, F, Cout);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = Cout <= 4 ? gat_mapping_fwd_kernel<1> : gat_mapping_fwd_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)NH);
  kernel<<<grid, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
