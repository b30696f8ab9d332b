// egt_native: the port's native host-side input-pipeline core.
//
// The port's own copy of the JAX package's batch core: the function bodies
// are the same, byte for byte, so both packages' native batches are equal.
// The loaders' hot loops (building overlapping frame windows, normalizing,
// changing the layout a batch) run here in C++ with std::thread parallelism
// and no GIL, called through ctypes (extended_gan_torch/data/native.py):
//
//   kmni_make_batch        : (T,V,H,W) raw video + window starts
//                            -> x,y float32 (B, Hc, Wc, S, V), fused
//                            value/max^power normalization + crop + layout
//   kmni_make_batch_merged : the same windows as the 2x3 vertex-pair mosaic
//                            (B, S, 2*Hc, 3*Wc)
//   window_gather          : (N, F) frames + starts -> (B, W, F) windows
//   minmax_normalize       : in-place (x - lo) / (hi - lo), threaded
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (driven by
// extended_gan_torch/data/native.py, into build/native/).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int n_workers(int64_t items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t cap = items < (int64_t)hw ? items : (int64_t)hw;
  return cap > 0 ? (int)cap : 1;
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int workers = n_workers(n);
  if (workers <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  int64_t chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    int64_t lo = w * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn]() {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// video: (T, V, H, W) float32 raw values (pre-normalization).
// starts: n window start frames; each window spans 2*steps frames:
//   frames [s, s+steps) -> x, [s+steps, s+2*steps) -> y.
// out_x/out_y: (n, crop_h, crop_w, steps, V) float32,
//   value = (raw * inv_max) ** power  (power==1 fast path).
void kmni_make_batch(const float* video, int64_t T, int64_t V, int64_t H,
                     int64_t W, const int64_t* starts, int64_t n,
                     int64_t steps, int64_t crop_h, int64_t crop_w,
                     float inv_max, float power, float* out_x,
                     float* out_y) {
  const int64_t frame = V * H * W;
  const int64_t out_per_win = crop_h * crop_w * steps * V;
  const bool pow1 = power == 1.0f;

  parallel_for(n, [&](int64_t i) {
    const int64_t s = starts[i];
    for (int half = 0; half < 2; ++half) {
      float* out = (half == 0 ? out_x : out_y) + i * out_per_win;
      const float* base = video + (s + half * steps) * frame;
      for (int64_t h = 0; h < crop_h; ++h) {
        for (int64_t w = 0; w < crop_w; ++w) {
          float* o = out + (h * crop_w + w) * steps * V;
          for (int64_t t = 0; t < steps; ++t) {
            const float* src = base + t * frame + h * W + w;
            for (int64_t v = 0; v < V; ++v) {
              float val = src[v * H * W] * inv_max;
              o[t * V + v] = pow1 ? val : std::pow(val, power);
            }
          }
        }
      }
    }
  });
}

// merge_nodes mosaic variant (kmni_data_loader.py:96-106): overlapping
// vertex pairs (0,1),(1,2),(2,3) tiled 2 high x 3 wide. Output layout is
// the reference's merged layout (n, steps, 2*crop_h, 3*crop_w) — note the
// reference only ever uses vertices 0..3 here regardless of V.
void kmni_make_batch_merged(const float* video, int64_t T, int64_t V,
                            int64_t H, int64_t W, const int64_t* starts,
                            int64_t n, int64_t steps, int64_t crop_h,
                            int64_t crop_w, float inv_max, float power,
                            float* out_x, float* out_y) {
  const int64_t frame = V * H * W;
  const int64_t oh = 2 * crop_h, ow = 3 * crop_w;
  const int64_t out_per_win = steps * oh * ow;
  const bool pow1 = power == 1.0f;

  parallel_for(n, [&](int64_t i) {
    const int64_t s = starts[i];
    for (int half = 0; half < 2; ++half) {
      float* out = (half == 0 ? out_x : out_y) + i * out_per_win;
      const float* base = video + (s + half * steps) * frame;
      for (int64_t t = 0; t < steps; ++t) {
        for (int64_t c = 0; c < 3; ++c) {    // mosaic column: pair (c, c+1)
          for (int64_t r = 0; r < 2; ++r) {  // row within the pair
            const float* src = base + t * frame + (c + r) * H * W;
            for (int64_t h = 0; h < crop_h; ++h) {
              float* o =
                  out + t * oh * ow + (r * crop_h + h) * ow + c * crop_w;
              const float* srow = src + h * W;
              for (int64_t w = 0; w < crop_w; ++w) {
                float val = srow[w] * inv_max;
                o[w] = pow1 ? val : std::pow(val, power);
              }
            }
          }
        }
      }
    }
  });
}

// frames: (N, F) float32; starts: n window starts; out: (n, window, F).
void window_gather(const float* frames, int64_t N, int64_t F,
                   const int64_t* starts, int64_t n, int64_t window,
                   float* out) {
  parallel_for(n, [&](int64_t i) {
    std::memcpy(out + i * window * F, frames + starts[i] * F,
                sizeof(float) * window * F);
  });
}

// in-place (x - lo) / (hi - lo) normalization over n elements, threaded
void minmax_normalize(float* data, int64_t n, float lo, float hi) {
  const float inv = 1.0f / (hi - lo);
  const int64_t chunk = 1 << 20;
  const int64_t blocks = (n + chunk - 1) / chunk;
  parallel_for(blocks, [&](int64_t b) {
    int64_t beg = b * chunk;
    int64_t end = beg + chunk < n ? beg + chunk : n;
    for (int64_t i = beg; i < end; ++i) data[i] = (data[i] - lo) * inv;
  });
}

int egt_native_abi_version() { return 2; }

}  // extern "C"
