// Fused GAT attention forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel extended_gan_tpu/ops/pallas/gat_attention.py:_kernel
// (launched by _pallas_forward). Per (head, batch element), on m of shape
// (M, P) in f32, with P = G * group_size and the groups contiguous:
//
//   s1_i = sum_p m[i,p] * a1[p / group_size] / group_size   (s2 likewise, a2)
//   e_ij = leaky_relu(s1_i + s2_j, alpha),  pos = (e > 0)
//   att0 = rowsoftmax(e),  att = adj_norm @ att0
//   out  = ELU(att @ m)
//
// and writes out (M, P) plus att0, att and pos (M, M each), the residuals a
// backward needs. `a` holds [a1; a2] (2G values per head) and is indexed by
// group: the TPU kernel's P-long repeated rows w1/w2 were a VMEM layout
// device, not part of the function, and are not materialised here.
//
// Bound: device-memory bytes. The function must read m once and write out
// once (8 bytes per element of m) against ~2M+3 flops per element, far below
// the H100's flop:byte balance. The TPU kernel holds one batch element's m in
// VMEM; here one element is 614 KB at 80x80 (M=4, P=38,400), more than the
// 227 KB a block can hold in shared memory. So the design is two passes over
// m by one block per (head, batch element):
//   pass 1 streams m with 16-byte loads and reduces s1, s2 over P
//          (per-thread partials, warp shuffles, then a fixed-order sum
//          across warps: deterministic);
//   one thread does the M x M algebra in shared memory;
//   pass 2 streams m again and writes out.
// The second read of m costs up to one more pass of bytes; at the served
// shapes most of it hits the 50 MB L2. Known limit: heads * batch blocks
// (96 at batch 32 with 3 heads) leave part of the 132 SMs idle, and one
// block per SM keeps few bytes in flight; splitting P over several blocks
// per element (with a cross-block reduction) is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
