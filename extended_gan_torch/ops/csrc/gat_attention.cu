// Fused GAT attention (K1) for Hopper, sm_90a: forward and backward.
//
// Replaces the TPU kernel extended_gan_tpu/ops/pallas/gat_attention.py:_kernel
// (launched by _pallas_forward) and the plain-JAX backward _bwd of the same
// file. Per (head, batch element), on m of shape (M, P) in f32, with
// P = G * S (G groups of S pixels; in GAT3D, T = M frames, V = G vertices
// and S = H * W pixels):
//
//   s1_i = sum_p m[i,p] * a1[p / S] / S   (s2 likewise, a2)
//   e_ij = leaky_relu(s1_i + s2_j, alpha),  pos = (e > 0)
//   att0 = rowsoftmax(e),  att = adj_norm @ att0
//   out  = ELU(att @ m)
//
// and writes out plus att0, att and pos (M, M each), the residuals the
// backward needs. `a` holds [a1; a2] (2G values a head) and is indexed by
// group: the TPU kernel's P-long repeated rows w1/w2 were a VMEM layout
// device, not part of the function, and are not materialised here.
//
// Bound: device-memory bytes. The forward must read m once and write out
// once (8 bytes an element of m), the backward read m and the cotangent g
// and write d_m (12 bytes), against a few flops an element: far below the
// H100's flop:byte balance.
//
// The cluster kernels. A thread-block cluster of C blocks (C <= 16; above 8
// the non-portable size) covers one (head, batch element) at a time. Rank
// r holds pixels [r * npix, (r + 1) * npix) of its element, every M * G
// value of each, in shared memory, copied in once by cp.async: the
// element's m is read from device memory once. A block reduces its slice's
// M * G plane sums (sum over its pixels of m[k, v, s]); after a cluster
// barrier every rank reads all C ranks' partials through distributed
// shared memory and adds them in rank order, so every block holds the same
// sums and runs are bit-identical (no atomics). s1 and s2 follow from the
// sums; every block does the M x M algebra (one thread), rank 0 alone
// writes the residuals; each block then computes its slice's outputs in
// place in shared memory and writes them back.
//
// Persistent clusters. The grid holds as many clusters as the card runs at
// once (at most one per element), and each walks elements first, first +
// clusters, ...; several blocks share an SM (the forward's four, the
// backward's two, where their slices fit), so one block's barriers and
// arithmetic overlap the others' copies.
// Partials alternate between two sets, so one cluster barrier an element
// suffices; a last one keeps every block resident until the others have
// read its partials.

// Layouts. The kernels read m where it lies and write out (and d_m) in the
// same layout, given an element's strides: pixel-major, each pixel's M * G
// values contiguous ((NH, B, H, W, T, V) contiguous, which the fused conv
// mapping K2 writes), or plane-major, each (k, v) plane's S pixels
// contiguous at any plane strides (the cuDNN mapping's view of memory
// ordered (B, V, NH, T, H, W), and the (NH, B, M, P) contiguous tensor of
// fused_gat_attention). The shared-memory slice keeps the tensor's order,
// so copies in and out are runs of 16-byte words where alignment allows.
// The wrapper makes any other layout contiguous (pixel-major) first.
//
// The backward (gat_attention_bwd) uses the same clusters and slices. With
// g = dL/dout, each block copies its slices of m and g, recomputes
// o = att @ m with the forward's FMA chain (so o > 0 and exp(o) match the
// forward's out bit for bit, and out is not read), d0 = g * ELU'(o), and
// reduces d_att = d0 m^T (M x M) and the plane sums; a cluster barrier and
// the rank-ordered sums again; one thread a block runs the M x M algebra
// of the softmax, the pos mask and the pooled scores to d_s1, d_s2; rank 0
// writes the element's d_adj (M x M) and d_a (2G) partials to a workspace;
// each block writes d_m = att^T d0 + d_s1 a1[v] + d_s2 a2[v] for its
// slice. A second small kernel sums the workspace over the batch in a
// fixed order. Where a block's slices of m and g do not fit its shared
// memory, the backward walks them in chunks, twice (the second pass reads
// m and g again).
//
// The one-block kernel (gat_attention_fwd) stays for the elements no
// cluster can hold in shared memory (beyond about 190 x 190 pixels at
// M = 4, G = 6): one block per (head, batch element) streams m twice,
// (NH, B, M, P) contiguous only.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// VEC = 4: 16-byte loads and stores (needs group_size % 4 == 0 and 16-byte
// aligned m / out); VEC = 1: scalar fallback for any shape.
template <int M, int VEC>
__global__ void __launch_bounds__(kThreads)
gat_attention_fwd_kernel(const float* __restrict__ m, const float* __restrict__ a,
                         const float* __restrict__ adj, float* __restrict__ out,
                         float* __restrict__ att0_out, float* __restrict__ att_out,
                         float* __restrict__ pos_out, int batch, int P,
                         int group_size, float alpha) {
  __shared__ float red[kWarps][2 * M];
  __shared__ float att_s[M][M];

  const int blk = blockIdx.x;  // head * batch + batch element
  const int head = blk / batch;
  const size_t base = (size_t)blk * M * P;
  const float* mb = m + base;
  float* ob = out + base;
  const int G = P / group_size;
  const float* a1 = a + (size_t)head * 2 * G;
  const float* a2 = a1 + G;
  const int nvec = P / VEC;
  const int group_vecs = group_size / VEC;

  // ---- pass 1: s1, s2 over P --------------------------------------------
  float s1[M], s2[M];
#pragma unroll
  for (int i = 0; i < M; ++i) s1[i] = s2[i] = 0.f;
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int g = q / group_vecs;
    const float w1 = __ldg(a1 + g), w2 = __ldg(a2 + g);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float r;
      if constexpr (VEC == 4) {
        const float4 v = load4(mb + (size_t)i * P + 4 * q);
        r = (v.x + v.y) + (v.z + v.w);
      } else {
        r = __ldg(mb + (size_t)i * P + q);
      }
      s1[i] = fmaf(r, w1, s1[i]);
      s2[i] = fmaf(r, w2, s2[i]);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s1[i] = warp_sum(s1[i]);
    s2[i] = warp_sum(s2[i]);
    if (lane == 0) {
      red[warp][i] = s1[i];
      red[warp][M + i] = s2[i];
    }
  }
  __syncthreads();

  // ---- the M x M algebra, one thread -----------------------------------
  if (threadIdx.x == 0) {
    const float inv_group = 1.f / (float)group_size;
    float t1[M], t2[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float u = 0.f, v = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        u += red[w][i];
        v += red[w][M + i];
      }
      t1[i] = u * inv_group;
      t2[i] = v * inv_group;
    }
    float att0[M][M];
    const size_t small = (size_t)blk * M * M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float e[M], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float x = t1[i] + t2[j];
        x = x > 0.f ? x : alpha * x;  // leaky_relu keeps the sign (alpha > 0)
        pos_out[small + i * M + j] = x > 0.f ? 1.f : 0.f;
        e[j] = x;
        mx = fmaxf(mx, x);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        e[j] = expf(e[j] - mx);
        sum += e[j];
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        att0[i][j] = e[j] / sum;
        att0_out[small + i * M + j] = att0[i][j];
      }
    }
    const float* adj_h = adj + (size_t)head * M * M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < M; ++k) acc = fmaf(adj_h[i * M + k], att0[k][j], acc);
        att_s[i][j] = acc;
        att_out[small + i * M + j] = acc;
      }
    }
  }
  __syncthreads();

  // ---- pass 2: out = ELU(att @ m) ----------------------------------------
  float w[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) w[i][k] = att_s[i][k];
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    if constexpr (VEC == 4) {
      float4 v[M];
#pragma unroll
      for (int k = 0; k < M; ++k) v[k] = load4(mb + (size_t)k * P + 4 * q);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < M; ++k) {
          o.x = fmaf(w[i][k], v[k].x, o.x);
          o.y = fmaf(w[i][k], v[k].y, o.y);
          o.z = fmaf(w[i][k], v[k].z, o.z);
          o.w = fmaf(w[i][k], v[k].w, o.w);
        }
        o = make_float4(elu(o.x), elu(o.y), elu(o.z), elu(o.w));
        *reinterpret_cast<float4*>(ob + (size_t)i * P + 4 * q) = o;
      }
    } else {
      float v[M];
#pragma unroll
      for (int k = 0; k < M; ++k) v[k] = __ldg(mb + (size_t)k * P + q);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float o = 0.f;
#pragma unroll
        for (int k = 0; k < M; ++k) o = fmaf(w[i][k], v[k], o);
        ob[(size_t)i * P + q] = elu(o);
      }
    }
  }
}


template <int M>
void launch(bool vec4, int blocks, cudaStream_t stream, const float* m,
            const float* a, const float* adj, float* out, float* att0,
            float* att, float* pos, int batch, int P, int group_size,
            float alpha) {
  if (vec4)
    gat_attention_fwd_kernel<M, 4><<<blocks, kThreads, 0, stream>>>(
        m, a, adj, out, att0, att, pos, batch, P, group_size, alpha);
  else
    gat_attention_fwd_kernel<M, 1><<<blocks, kThreads, 0, stream>>>(
        m, a, adj, out, att0, att, pos, batch, P, group_size, alpha);
}

// ---- the cluster kernels --------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
// Blocks an SM the registers allow (64 and 128 a thread): the forward's
// four overlap one another's copies, barriers and arithmetic where their
// slices fit a quarter of the SM's shared memory.
constexpr int kFwdBlocks = 4, kBwdBlocks = 2;
constexpr int kMaxMG = 128;      // M * G the cluster kernels take
constexpr int kMaxCluster = 16;  // blocks a cluster, non-portable above 8
constexpr int kMaxSmem = 232448;
constexpr int kAcc = (kMaxMG + kCWarps - 1) / kCWarps;  // planes a warp
constexpr int kPartLen = kMaxMG + 64;  // plane sums, then M * M more
// Shared memory, in floats: a header of small arrays, then the slice
// buffers.
constexpr int kPart = 0;                    // this block's partials, 2 sets
constexpr int kTot = kPart + 2 * kPartLen;  // the cluster's sums of them
constexpr int kRed = kTot + kPartLen;       // reduction scratch
constexpr int kRedLen = kCWarps * 64 > kCThreads ? kCWarps * 64 : kCThreads;
constexpr int kSmall = kRed + kRedLen;  // att, att0, pos, adj; d_s1, d_s2
constexpr int kAS = kSmall + 4 * 64 + 16;  // a1, a2
constexpr int kHeader = kAS + 2 * kMaxMG;
static_assert(kHeader % 4 == 0, "slice buffers start on 16 bytes");
static_assert(kMaxMG <= kCThreads, "a thread for each plane sum");

// Where one element's values lie: element (head n, batch b) starts at
// n * sn + b * sb; then (row k, group v, pixel s) at s * M * G + k * G + v
// (pixel-major) or k * sk + v * sv + s (plane-major).
struct Layout {
  long long sn, sb, sk, sv;
  int pixel_major;
};

__device__ __forceinline__ long long elem_base(const Layout& L, int e,
                                               int batch) {
  const int head = e / batch;
  return head * L.sn + (long long)(e - head * batch) * L.sb;
}

// A slice buffer keeps its tensor's order: pixel after pixel, or M * G
// planes of ld pixels.
__device__ __forceinline__ int buf_off(int pixel_major, int MG, int ld, int v,
                                       int s) {
  return pixel_major ? s * MG + v : v * ld + s;
}
__device__ __forceinline__ int buf_step(int pixel_major, int ld, int G) {
  return pixel_major ? G : G * ld;  // from row k to row k + 1
}

// Calls f(v, s) for each of n pixels' G * n columns (group v, pixel s),
// spread over the block in the order that keeps a warp's shared-memory
// reads on consecutive words for the layout: pixel-major, thread t takes
// group t % G of pixels t / G, t / G + kCThreads / G, ...; plane-major,
// pixels t, t + kCThreads, ... in every group.
template <typename F>
__device__ __forceinline__ void for_columns(int pixel_major, int G, int n,
                                            F f) {
  if (pixel_major) {
    const int per = kCThreads / G;
    if (threadIdx.x < per * G) {
      const int v = threadIdx.x % G;
      for (int s = threadIdx.x / G; s < n; s += per) f(v, s);
    }
  } else {
    for (int s = threadIdx.x; s < n; s += kCThreads)
      for (int v = 0; v < G; ++v) f(v, s);
  }
}

// ELU with the hardware exponential below 0: within about 2^-22 of expm1,
// far inside the forward's 1e-5, in a few instructions.
__device__ __forceinline__ float elu_exp(float x) {
  return x > 0.f ? x : __expf(x) - 1.f;
}

// Copies pixels [s0, s0 + n) of one element (src: its start) into a slice
// buffer, VEC floats a copy where the layout's alignment allows (VEC = 4
// in plane-major only where n % 4 == 0). One cp.async group.
template <int VEC>
__device__ __forceinline__ void load_slice(float* buf, const float* src,
                                           const Layout& L, int G, int MG,
                                           int ld, int s0, int n) {
  if (L.pixel_major) {
    const float* from = src + (long long)s0 * MG;
    const int len = n * MG, nv = len / VEC;
    for (int q = threadIdx.x; q < nv; q += kCThreads)
      __pipeline_memcpy_async(buf + q * VEC, from + q * VEC, 4 * VEC);
    for (int q = nv * VEC + threadIdx.x; q < len; q += kCThreads)
      __pipeline_memcpy_async(buf + q, from + q, 4);
  } else {
    const int nv = n / VEC;
    for (int q = threadIdx.x; q < MG * nv; q += kCThreads) {
      const int c = q / nv, i = q - c * nv, k = c / G, v = c - k * G;
      __pipeline_memcpy_async(buf + c * ld + i * VEC,
                              src + k * L.sk + v * L.sv + s0 + i * VEC,
                              4 * VEC);
    }
  }
  __pipeline_commit();
}

// The reverse of load_slice: the slice buffer to pixels [s0, s0 + n).
template <int VEC>
__device__ __forceinline__ void store_slice(float* dst, const float* buf,
                                            const Layout& L, int G, int MG,
                                            int ld, int s0, int n) {
  if (L.pixel_major) {
    float* to = dst + (long long)s0 * MG;
    const int len = n * MG, nv = len / VEC;
    for (int q = threadIdx.x; q < nv; q += kCThreads) {
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(to + 4 * q) =
            *reinterpret_cast<const float4*>(buf + 4 * q);
      else
        to[q] = buf[q];
    }
    for (int q = nv * VEC + threadIdx.x; q < len; q += kCThreads) to[q] = buf[q];
  } else {
    const int nv = n / VEC;
    for (int q = threadIdx.x; q < MG * nv; q += kCThreads) {
      const int c = q / nv, i = q - c * nv, k = c / G, v = c - k * G;
      float* p = dst + k * L.sk + v * L.sv + s0 + i * VEC;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(p) =
            *reinterpret_cast<const float4*>(buf + c * ld + 4 * i);
      else
        *p = buf[c * ld + i];
    }
  }
}

// Adds n pixels of a slice buffer to this thread's share of the M * G
// plane sums. Pixel-major: thread (r, c) sums plane c over pixels r, r +
// rows, ...; plane-major: warp w sums planes w, w + kCWarps, ... over its
// lanes' pixels. The shares are fixed, so the order of every sum is.
__device__ __forceinline__ void plane_sums_add(float (&acc)[kAcc],
                                               const float* buf,
                                               int pixel_major, int MG,
                                               int ld, int n) {
  if (pixel_major) {
    const int rows = kCThreads / MG;
    if (threadIdx.x < rows * MG) {
      const int r = threadIdx.x / MG, c = threadIdx.x - r * MG;
      for (int s = r; s < n; s += rows) acc[0] += buf[s * MG + c];
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int c = warp + j * kCWarps;
      if (c < MG)
        for (int s = lane; s < n; s += 32) acc[j] += buf[c * ld + s];
    }
  }
}

// This block's M * G plane sums into out[0, MG), from the threads' shares.
// Visible to the block after its next barrier.
__device__ __forceinline__ void plane_sums_finish(float (&acc)[kAcc],
                                                  float* red, float* out,
                                                  int pixel_major, int MG) {
  if (pixel_major) {
    const int rows = kCThreads / MG;
    red[threadIdx.x] = acc[0];
    __syncthreads();
    if (threadIdx.x < MG) {
      float t = 0.f;
      for (int r = 0; r < rows; ++r) t += red[r * MG + threadIdx.x];
      out[threadIdx.x] = t;
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const float t = warp_sum(acc[j]);
      const int c = warp + j * kCWarps;
      if (lane == 0 && c < MG) out[c] = t;
    }
  }
}

// Every rank's values [0, len) of `part`, added in rank order into tot.
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float* part, float* tot, int len) {
  const int C = (int)cluster.num_blocks();
  for (int q = threadIdx.x; q < len; q += kCThreads) {
    float t = 0.f;
    for (int r = 0; r < C; ++r) t += *cluster.map_shared_rank(part + q, r);
    tot[q] = t;
  }
}

// Stages one element's small inputs in shared memory: its head's adj
// (M x M) and a (2G), and, in the backward, its att0, att, pos.
template <int M>
__device__ __forceinline__ void stage_small(float* smem, const float* a,
                                            const float* adj,
                                            const float* att0,
                                            const float* att,
                                            const float* pos, int e,
                                            int batch, int G) {
  const int head = e / batch;
  const long long small = (long long)e * M * M;
  for (int q = threadIdx.x; q < M * M; q += kCThreads) {
    smem[kSmall + 192 + q] = adj[(long long)head * M * M + q];
    if (att) {
      smem[kSmall + q] = att[small + q];
      smem[kSmall + 64 + q] = att0[small + q];
      smem[kSmall + 128 + q] = pos[small + q];
    }
  }
  for (int q = threadIdx.x; q < 2 * G; q += kCThreads)
    smem[kAS + q] = a[(long long)head * 2 * G + q];
}

// Warp 0: the attention of one element from its plane sums tot (M * G),
// a1, a2 (G each) and adj_h (M x M), in shared memory, lane q on the
// entries (i, j) = (q / M, q % M), q = lane, lane + 32, ...: e and att0
// through the scratch e_s and att0_s, att to att_s; where `write`, att0,
// att and pos (row-major) to att0_o, att_o and pos_o. Every sum runs in
// the first kernel's order.
template <int M>
__device__ __forceinline__ void attention(const float* tot, const float* a1,
                                          const float* a2,
                                          const float* adj_h, int G, int S,
                                          float alpha, bool write,
                                          float* att0_o, float* att_o,
                                          float* pos_o, float* e_s,
                                          float* att0_s, float* att_s) {
  const int lane = threadIdx.x % 32;
  const float inv_group = 1.f / (float)S;
  for (int q = lane; q < M * M; q += 32) {
    const int i = q / M, j = q - i * M;
    float u = 0.f, w = 0.f;
    for (int v = 0; v < G; ++v) {
      u = fmaf(a1[v], tot[i * G + v], u);
      w = fmaf(a2[v], tot[j * G + v], w);
    }
    float x = u * inv_group + w * inv_group;
    x = x > 0.f ? x : alpha * x;  // leaky_relu keeps the sign (alpha > 0)
    if (write) pos_o[q] = x > 0.f ? 1.f : 0.f;
    e_s[q] = x;
  }
  __syncwarp();
  for (int q = lane; q < M * M; q += 32) {
    const int i = q / M;
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int k = 0; k < M; ++k) mx = fmaxf(mx, e_s[i * M + k]);
#pragma unroll
    for (int k = 0; k < M; ++k) sum += expf(e_s[i * M + k] - mx);
    const float p = expf(e_s[q] - mx) / sum;
    att0_s[q] = p;
    if (write) att0_o[q] = p;
  }
  __syncwarp();
  for (int q = lane; q < M * M; q += 32) {
    const int i = q / M, j = q - i * M;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < M; ++k) acc = fmaf(adj_h[i * M + k], att0_s[k * M + j], acc);
    att_s[q] = acc;
    if (write) att_o[q] = acc;
  }
}

// The forward. A cluster walks elements first, first + stride, ... (stride
// = the clusters of the grid), one at a time.
template <int M, int VEC>
__global__ void __launch_bounds__(kCThreads, kFwdBlocks)
gat_attention_cluster_fwd_kernel(const float* __restrict__ m,
                                 const float* __restrict__ a,
                                 const float* __restrict__ adj,
                                 float* __restrict__ out,
                                 float* __restrict__ att0_out,
                                 float* __restrict__ att_out,
                                 float* __restrict__ pos_out, Layout L,
                                 int batch, int elements, int G, int S,
                                 int npix, float alpha) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int first = blockIdx.x / C, stride = gridDim.x / C;
  const int MG = M * G, ld = npix;
  const int s0 = rank * npix, n = max(0, min(npix, S - s0));
  const int step = buf_step(L.pixel_major, ld, G);
  float* att_s = smem + kSmall;
  float* buf = smem + kHeader;

  int i = 0;
  for (int e = first; e < elements; e += stride, ++i) {
    float* part = smem + kPart + (i & 1) * kPartLen;
    const long long base = elem_base(L, e, batch);
    load_slice<VEC>(buf, m + base, L, G, MG, ld, s0, n);
    __pipeline_wait_prior(0);
    stage_small<M>(smem, a, adj, nullptr, nullptr, nullptr, e, batch, G);
    __syncthreads();
    float acc[kAcc] = {};
    plane_sums_add(acc, buf, L.pixel_major, MG, ld, n);
    plane_sums_finish(acc, smem + kRed, part, L.pixel_major, MG);
    // every rank's partials are written; the set of two elements back is
    // no longer read (its readers passed the previous barrier)
    cluster.sync();
    cluster_sum(cluster, part, smem + kTot, MG);
    __syncthreads();
    if (threadIdx.x < 32) {
      const long long small = (long long)e * M * M;
      attention<M>(smem + kTot, smem + kAS, smem + kAS + G,
                   smem + kSmall + 192, G, S, alpha, rank == 0,
                   att0_out + small, att_out + small, pos_out + small,
                   smem + kSmall + 128, smem + kSmall + 64, att_s);
    }
    __syncthreads();
    float w[M][M];
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int k = 0; k < M; ++k) w[r][k] = att_s[r * M + k];
    if (!L.pixel_major && VEC == 4) {  // four pixels of a plane a thread
      const int q4 = n / 4;
      for (int j = threadIdx.x; j < G * q4; j += kCThreads) {
        const int v = j / q4;
        float* p = buf + v * ld + 4 * (j - v * q4);
        float4 x[M];
#pragma unroll
        for (int k = 0; k < M; ++k)
          x[k] = *reinterpret_cast<const float4*>(p + k * step);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < M; ++k) {
            o.x = fmaf(w[r][k], x[k].x, o.x);
            o.y = fmaf(w[r][k], x[k].y, o.y);
            o.z = fmaf(w[r][k], x[k].z, o.z);
            o.w = fmaf(w[r][k], x[k].w, o.w);
          }
          *reinterpret_cast<float4*>(p + r * step) = make_float4(
              elu_exp(o.x), elu_exp(o.y), elu_exp(o.z), elu_exp(o.w));
        }
      }
    } else {
      for_columns(L.pixel_major, G, n, [&](int v, int s) {
        const int o0 = buf_off(L.pixel_major, MG, ld, v, s);
        float x[M];
#pragma unroll
        for (int k = 0; k < M; ++k) x[k] = buf[o0 + k * step];
#pragma unroll
        for (int r = 0; r < M; ++r) {
          float o = 0.f;
#pragma unroll
          for (int k = 0; k < M; ++k) o = fmaf(w[r][k], x[k], o);
          buf[o0 + r * step] = elu_exp(o);
        }
      });
    }
    __syncthreads();
    store_slice<VEC>(out + base, buf, L, G, MG, ld, s0, n);
    __syncthreads();  // the buffer is free for the next element
  }
  cluster.sync();  // no block leaves while another may read its partials
}

// The backward of one element: pass 1 (d0, d_att, the plane sums), the
// cluster's sums, the M x M algebra, pass 2 (d_m), in chunks of `chunk`
// pixels; with one chunk its m and g are already in bufm and bufg.
template <int M, int VEC>
__device__ __forceinline__ void bwd_element(
    cg::cluster_group& cluster, float* smem, float* bufm, float* bufg,
    const float* m, const float* g, float* dm, float* wse, const Layout& Lm,
    const Layout& Lg, int G, int S, int s0, int n, int chunk, float* part,
    float alpha) {
  const int rank = (int)cluster.block_rank();
  const int MG = M * G, ld = chunk, mm = M * M;
  const int chunks = (n + chunk - 1) / chunk;
  const int pm = Lm.pixel_major, pg = Lg.pixel_major;
  const int stm = buf_step(pm, ld, G), stg = buf_step(pg, ld, G);
  const float* sm_att = smem + kSmall;
  const float* sm_att0 = sm_att + 64;
  const float* sm_pos = sm_att + 128;
  const float* sm_adj = sm_att + 192;
  float* sm_ds1 = smem + kSmall + 256;
  float* sm_ds2 = sm_ds1 + 8;
  const float* sm_a = smem + kAS;
  float w[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) w[i][k] = sm_att[i * M + k];

  // ---- pass 1: d0 = g * ELU'(att @ m), d_att = d0 m^T, the plane sums ----
  float datt[M][M] = {};
  float acc[kAcc] = {};
  for (int c = 0; c < chunks; ++c) {
    const int cs = s0 + c * chunk, cn = min(chunk, n - c * chunk);
    if (chunks > 1) {
      __syncthreads();  // the previous chunk is read
      load_slice<VEC>(bufm, m, Lm, G, MG, ld, cs, cn);
      load_slice<VEC>(bufg, g, Lg, G, MG, ld, cs, cn);
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    plane_sums_add(acc, bufm, pm, MG, ld, cn);
    for_columns(pm, G, cn, [&](int v, int s) {
      const int om = buf_off(pm, MG, ld, v, s);
      const int og = buf_off(pg, MG, ld, v, s);
      float x[M];
#pragma unroll
      for (int k = 0; k < M; ++k) x[k] = bufm[om + k * stm];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float o = 0.f;
#pragma unroll
        for (int k = 0; k < M; ++k) o = fmaf(w[i][k], x[k], o);
        const float gi = bufg[og + i * stg];
        const float d0 = gi * (o > 0.f ? 1.f : __expf(o));
#pragma unroll
        for (int k = 0; k < M; ++k) datt[i][k] = fmaf(d0, x[k], datt[i][k]);
        if (chunks == 1) bufg[og + i * stg] = d0;
      }
    });
  }
  float* red = smem + kRed;
  plane_sums_finish(acc, red, part, pm, MG);
  __syncthreads();  // red is free again
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float t = warp_sum(datt[i][k]);
      if (lane == 0) red[warp * mm + i * M + k] = t;
    }
  __syncthreads();
  for (int q = threadIdx.x; q < mm; q += kCThreads) {
    float t = 0.f;
    for (int r = 0; r < kCWarps; ++r) t += red[r * mm + q];
    part[MG + q] = t;
  }
  cluster.sync();  // every rank's partials are written
  float* tot = smem + kTot;
  cluster_sum(cluster, part, tot, MG + mm);
  __syncthreads();

  // ---- the M x M algebra on warp 0: d_adj, d_s1, d_s2, d_a ---------------
  // lane q on the entries (k, j) = (q / M, q % M); every sum in index order
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float inv_group = 1.f / (float)S;
    const float* datt = tot + MG;
    float* da0_s = red;      // d_att0 (M x M), red is free here
    float* de_s = red + 64;  // d_e (M x M)
    for (int q = lane; q < mm; q += 32) {
      const int k = q / M, j = q - k * M;
      // att = adj @ att0: d_adj[k][j] = sum_l d_att[k][l] att0[j][l],
      // d_att0[k][j] = sum_i adj[i][k] d_att[i][j]
      if (rank == 0) {
        float t = 0.f;
#pragma unroll
        for (int l = 0; l < M; ++l)
          t = fmaf(datt[k * M + l], sm_att0[j * M + l], t);
        wse[q] = t;
      }
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < M; ++i) t = fmaf(sm_adj[i * M + k], datt[i * M + j], t);
      da0_s[q] = t;
    }
    __syncwarp();
    for (int q = lane; q < mm; q += 32) {  // softmax rows, leaky_relu'
      const int k = q / M;
      float dot = 0.f;
#pragma unroll
      for (int l = 0; l < M; ++l)
        dot = fmaf(da0_s[k * M + l], sm_att0[k * M + l], dot);
      const float e = sm_att0[q] * (da0_s[q] - dot);
      de_s[q] = sm_pos[q] > 0.f ? e : alpha * e;
    }
    __syncwarp();
    // e[i][j] = s1_i + s2_j, s = (m @ w) / S
    if (lane < M) {
      float r = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) r += de_s[lane * M + j];
      sm_ds1[lane] = r * inv_group;
    } else if (lane < 2 * M) {
      float c = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) c += de_s[j * M + lane - M];
      sm_ds2[lane - M] = c * inv_group;
    }
    __syncwarp();
    if (rank == 0) {  // w = a repeated over a group: d_a sums the group
      for (int v = lane; v < G; v += 32) {
        float u = 0.f, x = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          u = fmaf(sm_ds1[i], tot[i * G + v], u);
          x = fmaf(sm_ds2[i], tot[i * G + v], x);
        }
        wse[mm + v] = u;
        wse[mm + G + v] = x;
      }
    }
  }
  __syncthreads();

  // ---- pass 2: d_m = att^T d0 + d_s1 a1[v] + d_s2 a2[v], in m's layout --
  float ds1[M], ds2[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    ds1[k] = sm_ds1[k];
    ds2[k] = sm_ds2[k];
  }
  for (int c = 0; c < chunks; ++c) {
    const int cs = s0 + c * chunk, cn = min(chunk, n - c * chunk);
    if (chunks > 1) {
      __syncthreads();  // the previous chunk is stored
      load_slice<VEC>(bufm, m, Lm, G, MG, ld, cs, cn);
      load_slice<VEC>(bufg, g, Lg, G, MG, ld, cs, cn);
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    for_columns(pm, G, cn, [&](int v, int s) {
      const int om = buf_off(pm, MG, ld, v, s);
      const int og = buf_off(pg, MG, ld, v, s);
      float d0[M];
      if (chunks == 1) {
#pragma unroll
        for (int i = 0; i < M; ++i) d0[i] = bufg[og + i * stg];
      } else {
        float x[M];
#pragma unroll
        for (int k = 0; k < M; ++k) x[k] = bufm[om + k * stm];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          float o = 0.f;
#pragma unroll
          for (int k = 0; k < M; ++k) o = fmaf(w[i][k], x[k], o);
          const float gi = bufg[og + i * stg];
          d0[i] = gi * (o > 0.f ? 1.f : __expf(o));
        }
      }
      const float a1 = sm_a[v], a2 = sm_a[G + v];
#pragma unroll
      for (int k = 0; k < M; ++k) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) t = fmaf(w[i][k], d0[i], t);
        bufm[om + k * stm] = t + ds1[k] * a1 + ds2[k] * a2;
      }
    });
    __syncthreads();
    store_slice<VEC>(dm, bufm, Lm, G, MG, ld, cs, cn);
  }
}

// The backward, walking elements as the forward does; where a block's
// slices are longer than `chunk` pixels it walks them in chunks, twice.
template <int M, int VEC>
__global__ void __launch_bounds__(kCThreads, kBwdBlocks)
gat_attention_cluster_bwd_kernel(
    const float* __restrict__ m, const float* __restrict__ g,
    const float* __restrict__ a, const float* __restrict__ adj,
    const float* __restrict__ att0, const float* __restrict__ att,
    const float* __restrict__ pos, float* __restrict__ dm,
    float* __restrict__ ws, Layout Lm, Layout Lg, int batch, int elements,
    int G, int S, int npix, int chunk, float alpha) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int first = blockIdx.x / C, stride = gridDim.x / C;
  const int MG = M * G;
  const int s0 = rank * npix, n = max(0, min(npix, S - s0));
  float* bufm = smem + kHeader;
  float* bufg = bufm + chunk * MG;

  int i = 0;
  for (int e = first; e < elements; e += stride, ++i) {
    const long long bm = elem_base(Lm, e, batch), bg = elem_base(Lg, e, batch);
    if (n <= chunk) {  // the slices fit one chunk: copied in here
      load_slice<VEC>(bufm, m + bm, Lm, G, MG, chunk, s0, n);
      load_slice<VEC>(bufg, g + bg, Lg, G, MG, chunk, s0, n);
      __pipeline_wait_prior(0);
    }
    stage_small<M>(smem, a, adj, att0, att, pos, e, batch, G);
    __syncthreads();
    bwd_element<M, VEC>(cluster, smem, bufm, bufg, m + bm, g + bg, dm + bm,
                        ws + (long long)e * (M * M + 2 * G), Lm, Lg, G, S, s0,
                        n, chunk, smem + kPart + (i & 1) * kPartLen, alpha);
    __syncthreads();  // the buffers are free for the next element
  }
  cluster.sync();  // no block leaves while another may read its partials
}

// sums[h][j] = sum over the batch of ws[h][b][j], in batch order.
__global__ void gat_attention_bwd_sum_kernel(const float* __restrict__ ws,
                                             float* __restrict__ sums,
                                             int n_heads, int batch, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_heads * W) return;
  const int h = i / W, j = i - h * W;
  float t = 0.f;
  for (int b = 0; b < batch; ++b) t += ws[((long long)h * batch + b) * W + j];
  sums[i] = t;
}

long long cluster_smem_bytes(int MG, int pixels, int buffers) {
  return 4LL * (kHeader + (long long)buffers * pixels * MG);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether a layout's slices can be copied in 16-byte words: 16-byte
// aligned element starts and, plane-major, plane starts and runs.
bool vec_layout(const void* p, const Layout& L, int S) {
  return aligned16(p) && L.sn % 4 == 0 && L.sb % 4 == 0 &&
         (L.pixel_major || (S % 4 == 0 && L.sk % 4 == 0 && L.sv % 4 == 0));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int C, long long smem,
                    cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                    unsigned blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <typename Kernel>
int max_clusters(Kernel kernel, int C, long long smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = prepare(kernel, C, smem, cfg, attr, (unsigned)C, nullptr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int C, long long smem, unsigned blocks,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = prepare(kernel, C, smem, cfg, attr, blocks, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel instance for M (1..8) and VEC (1 or 4): F<M, VEC>::run(args).
template <template <int, int> class F, typename... Args>
int dispatch(int M, bool vec, Args... args) {
  switch (M * 2 + (vec ? 1 : 0)) {
#define GAT_CASE(MM)                                      \
  case 2 * MM: return F<MM, 1>::run(args...);             \
  case 2 * MM + 1: return F<MM, 4>::run(args...);
    GAT_CASE(1) GAT_CASE(2) GAT_CASE(3) GAT_CASE(4)
    GAT_CASE(5) GAT_CASE(6) GAT_CASE(7) GAT_CASE(8)
#undef GAT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int M, int VEC>
struct FwdKernel {
  template <typename... Args>
  static int run(int C, long long smem, unsigned blocks, cudaStream_t s,
                 Args... args) {
    return launch_cluster(gat_attention_cluster_fwd_kernel<M, VEC>, C, smem,
                          blocks, s, args...);
  }
};

template <int M, int VEC>
struct BwdKernel {
  template <typename... Args>
  static int run(int C, long long smem, unsigned blocks, cudaStream_t s,
                 Args... args) {
    return launch_cluster(gat_attention_cluster_bwd_kernel<M, VEC>, C, smem,
                          blocks, s, args...);
  }
};

template <int M, int VEC>
struct Occupancy {
  static int run(int backward, int C, long long smem) {
    return backward
               ? max_clusters(gat_attention_cluster_bwd_kernel<M, VEC>, C, smem)
               : max_clusters(gat_attention_cluster_fwd_kernel<M, VEC>, C, smem);
  }
};

// The checks both cluster entry points make; false when the plan or the
// shape is not one the kernels take.
bool cluster_plan_ok(int n_heads, int batch, int M, int G, int S, int C,
                     int npix, int chunk, int clusters, long long smem) {
  return n_heads >= 1 && batch >= 1 && M >= 1 && M <= 8 && G >= 1 &&
         M * G <= kMaxMG && S >= 1 && C >= 1 && C <= kMaxCluster &&
         npix >= 4 && npix % 4 == 0 && (long long)C * npix >= S &&
         chunk >= 4 && chunk % 4 == 0 && chunk <= npix && clusters >= 1 &&
         clusters <= n_heads * batch && smem <= kMaxSmem &&
         (long long)clusters * C <= 0x7fffffffLL;
}

}  // namespace

// m: (n_heads, batch, M, P); a: (n_heads, 2G); adj: (n_heads, M, M);
// out like m; att0, att, pos: (n_heads, batch, M, M). All f32, contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gat_attention_fwd(const void* m, const void* a, const void* adj,
                                 void* out, void* att0, void* att, void* pos,
                                 int n_heads, int batch, int M, int P,
                                 int group_size, float alpha, void* stream) {
  if (n_heads < 1 || batch < 1 || P < 1 || group_size < 1 || P % group_size != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = group_size % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = n_heads * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* af = static_cast<const float*>(a);
  const float* jf = static_cast<const float*>(adj);
  float* of = static_cast<float*>(out);
  float* a0 = static_cast<float*>(att0);
  float* at = static_cast<float*>(att);
  float* ps = static_cast<float*>(pos);
  switch (M) {
#define GAT_CASE(MM) \
  case MM: launch<MM>(vec4, blocks, s, mf, af, jf, of, a0, at, ps, batch, P, group_size, alpha); break;
    GAT_CASE(1) GAT_CASE(2) GAT_CASE(3) GAT_CASE(4)
    GAT_CASE(5) GAT_CASE(6) GAT_CASE(7) GAT_CASE(8)
#undef GAT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Bytes of shared memory a cluster block takes: the header and `buffers`
// slice buffers of `pixels` pixels (the forward 1, the backward 2: m's and
// g's).
extern "C" long long gat_attention_cluster_smem_bytes(int M, int G, int pixels,
                                                      int buffers) {
  return cluster_smem_bytes(M * G, pixels, buffers);
}

// How many clusters of C blocks with `smem` bytes each the card runs at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int gat_attention_cluster_max_clusters(int M, int vec, int backward,
                                                  int C, long long smem) {
  if (M < 1 || M > 8 || C < 1 || C > kMaxCluster || smem > kMaxSmem)
    return -(int)cudaErrorInvalidValue;
  return dispatch<Occupancy>(M, vec != 0, backward, C, smem);
}

// The cluster forward. m and out: n_heads * batch elements of M rows, G
// groups and S pixels in one layout (sn, sb, sk, sv, pixel_major: see
// Layout); a: (n_heads, 2G); adj: (n_heads, M, M); att0, att, pos:
// (n_heads, batch, M, M) contiguous. `clusters` clusters of C blocks walk
// the elements, npix pixels a block (a multiple of 4, C * npix >= S).
// Returns cudaGetLastError() after the launch.
extern "C" int gat_attention_cluster_fwd(
    const void* m, const void* a, const void* adj, void* out, void* att0,
    void* att, void* pos, int n_heads, int batch, int M, int G, int S,
    long long sn, long long sb, long long sk, long long sv, int pixel_major,
    int C, int npix, int clusters, float alpha, void* stream) {
  const long long smem = cluster_smem_bytes(M * G, npix, 1);
  if (!cluster_plan_ok(n_heads, batch, M, G, S, C, npix, npix, clusters,
                       smem))
    return (int)cudaErrorInvalidValue;
  const Layout L{sn, sb, sk, sv, pixel_major};
  const bool vec = vec_layout(m, L, S) && vec_layout(out, L, S);
  return dispatch<FwdKernel>(
      M, vec, C, smem, (unsigned)(clusters * C),
      static_cast<cudaStream_t>(stream), static_cast<const float*>(m),
      static_cast<const float*>(a), static_cast<const float*>(adj),
      static_cast<float*>(out), static_cast<float*>(att0),
      static_cast<float*>(att), static_cast<float*>(pos), L, batch,
      n_heads * batch, G, S, npix, alpha);
}

// The backward. m and dm in m's layout, g in its own (both as in
// gat_attention_cluster_fwd); a, adj, att0, att, pos as there; ws:
// n_heads * batch * (M * M + 2G) floats of scratch; sums: (n_heads,
// M * M + 2G), each head's d_adj (M x M) then d_a (2G). Slices of npix
// pixels, in chunks of `chunk` pixels. Returns cudaGetLastError() after
// the two launches.
extern "C" int gat_attention_bwd(
    const void* m, const void* g, const void* a, const void* adj,
    const void* att0, const void* att, const void* pos, void* dm, void* ws,
    void* sums, int n_heads, int batch, int M, int G, int S, long long msn,
    long long msb, long long msk, long long msv, int m_pixel_major,
    long long gsn, long long gsb, long long gsk, long long gsv,
    int g_pixel_major, int C, int npix, int chunk, int clusters, float alpha,
    void* stream) {
  const long long smem = cluster_smem_bytes(M * G, chunk, 2);
  if (!cluster_plan_ok(n_heads, batch, M, G, S, C, npix, chunk, clusters,
                       smem))
    return (int)cudaErrorInvalidValue;
  const Layout Lm{msn, msb, msk, msv, m_pixel_major};
  const Layout Lg{gsn, gsb, gsk, gsv, g_pixel_major};
  const bool vec = vec_layout(m, Lm, S) && vec_layout(dm, Lm, S) &&
                   vec_layout(g, Lg, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch<BwdKernel>(
      M, vec, C, smem, (unsigned)(clusters * C), s,
      static_cast<const float*>(m), static_cast<const float*>(g),
      static_cast<const float*>(a), static_cast<const float*>(adj),
      static_cast<const float*>(att0), static_cast<const float*>(att),
      static_cast<const float*>(pos), static_cast<float*>(dm),
      static_cast<float*>(ws), Lm, Lg, batch, n_heads * batch, G, S, npix,
      chunk, alpha);
  if (rc != 0) return rc;
  const int W = M * M + 2 * G;
  gat_attention_bwd_sum_kernel<<<(n_heads * W + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(sums), n_heads, batch,
      W);
  return (int)cudaGetLastError();
}
