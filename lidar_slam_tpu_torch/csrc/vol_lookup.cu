// K4: the trilinear volume lookups (ops/correlative.lookup_cascade,
// lookup_avg_distance and refine_estimate) as one launch a call.
//
// Replaces no TPU kernel: the JAX package's lookup is plain jnp code, which
// XLA fuses on the TPU. On the card the plain PyTorch version is about 209
// small kernels a lookup_cascade call (for each level the fractional index,
// the window test, the clamp and floor, then for each of the 8 corners its
// weight, three index clamps, the flat index, two gathers and two
// multiply-adds), and a particle-filter step makes four such calls (its
// 1024 particles once, the estimate's 27 candidates three times) with an
// argmin and a gather after each refinement pass: about 850 launches a scan
// inside the captured step, each a graph node of ~1.3 us.
//
// What bounds it on the H100: at the PF shape (1024 poses, one level of
// 7 x 13 x 13) the work is 16 gathers a pose from a score and a count
// volume of 9.5 KB together that K2 has just written (in L2), 12 KB of
// poses and 5 KB of outputs: ~26 KB, under 10 ns of bytes at 3.35 TB/s,
// and ~100 float operations a pose. What is left is the launch and one
// dependent chain of operations a thread. So the design is the plainest:
//
// - vol_lookup_kernel: one thread a pose, 128 a block. It computes every
//   level of the cascade in order in its registers (fractional index,
//   window test, clamp, floor, the 8 corners in (dt, dy, dx) order) and
//   stops at the first level whose window holds the pose, as
//   lookup_cascade's selection does (the coarsest level where none does);
//   it writes the distance and, for a cascade, the fine window's escape
//   mask. A batched volume (B, T, W, W) serves the poses of row b, as
//   correlative._base_for broadcasts them. One level with no mask is
//   lookup_avg_distance.
// - vol_refine_kernel: one block. Thread k looks up candidate est + offs[k]
//   through the same device function; thread 0 takes the first minimum
//   (the first NaN where there is one, as torch.argmin takes it) and moves
//   the estimate; REFINE_PASSES (3) times (correlative.refine_estimate).
//
// Exactness: every operation of the plain version is repeated in the same
// order in float32 with the round-to-nearest intrinsics (the build passes
// --fmad=false besides, so no multiply and add are contracted into an FMA):
// (p - base) * ipixel + half, an IEEE division by the float32 theta step,
// clamps that keep a NaN as torch.clamp does, each weight as
// ((w_t * w_y) * w_x), num and den summed from 0 corner by corner, and
// num / max(den, 1) (a NaN den kept) times 2^level. So the result is the
// plain version's bit for bit on the card.
//
// Everything is read from device memory (poses, bases, volumes), so the
// launch needs no host sync and a CUDA graph can hold it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 3;
constexpr int THREADS = 128;        // poses a block of vol_lookup_kernel
constexpr int MAX_CANDIDATES = 1024;
constexpr int REFINE_PASSES = 3;  // correlative.REFINE_PASSES

struct Level {
  const float* scores;  // (B, T, W, W)
  const float* counts;  // (B, T, W, W)
  const float* base;    // (B, 3)
  float ipixel;
  float theta_step;
};

// the cascade, finest level first; every level has B x (T, W, W)
struct Cascade {
  Level level[MAX_LEVELS];
  int levels, T, W, half;
};

// torch.clamp(v, lo, hi): a NaN passes through
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// a floored index as an int; a NaN reads corner 0, whose weights are NaN,
// so the result is NaN whatever is read
__device__ __forceinline__ int corner(float floored) {
  return isnan(floored) ? 0 : static_cast<int>(floored);
}

// One pose at level `lvl` of volume row b: its average distance times
// 2^lvl (correlative.lookup_avg_distance), and in *inside whether it lies
// in the level's window (correlative._window_inside).
__device__ float lookup(const Cascade& c, int lvl, int b, float px, float py,
                        float pt, bool* inside) {
  const Level& L = c.level[lvl];
  const float* base = L.base + 3 * b;
  // the fractional index (correlative._fractional_index)
  const float fdx = __fadd_rn(__fmul_rn(__fsub_rn(px, base[0]), L.ipixel),
                              static_cast<float>(c.half));
  const float fdy = __fadd_rn(__fmul_rn(__fsub_rn(py, base[1]), L.ipixel),
                              static_cast<float>(c.half));
  const float fdt = __fadd_rn(__fdiv_rn(__fsub_rn(pt, base[2]), L.theta_step),
                              static_cast<float>(c.T / 2));
  const float w = static_cast<float>(2 * c.half);
  *inside = fdx >= 0.f && fdx <= w && fdy >= 0.f && fdy <= w && fdt >= 0.f &&
            fdt <= static_cast<float>(c.T - 1);
  // clamped into the window, so a pose beyond an edge ties with the edge
  const float ft = clamp_keep_nan(fdt, 0.f, static_cast<float>(c.T - 1));
  const float fy = clamp_keep_nan(fdy, 0.f, static_cast<float>(c.W - 1));
  const float fx = clamp_keep_nan(fdx, 0.f, static_cast<float>(c.W - 1));
  const float t0 = floorf(ft), y0 = floorf(fy), x0 = floorf(fx);
  const float at = __fsub_rn(ft, t0), ay = __fsub_rn(fy, y0),
              ax = __fsub_rn(fx, x0);
  const float wt[2] = {__fsub_rn(1.f, at), at};
  const float wy[2] = {__fsub_rn(1.f, ay), ay};
  const float wx[2] = {__fsub_rn(1.f, ax), ax};
  const int it = corner(t0), iy = corner(y0), ix = corner(x0);
  const int volume = c.T * c.W * c.W;
  const float* scores = L.scores + static_cast<size_t>(b) * volume;
  const float* counts = L.counts + static_cast<size_t>(b) * volume;
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int dt = 0; dt < 2; ++dt) {
    const int ti = min(it + dt, c.T - 1);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = min(iy + dy, c.W - 1);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = min(ix + dx, c.W - 1);
        const int idx = (ti * c.W + yi) * c.W + xi;
        const float wgt = __fmul_rn(__fmul_rn(wt[dt], wy[dy]), wx[dx]);
        num = __fadd_rn(num, __fmul_rn(wgt, __ldg(scores + idx)));
        den = __fadd_rn(den, __fmul_rn(wgt, __ldg(counts + idx)));
      }
    }
  }
  // torch.clamp(den, min=1) keeps a NaN
  const float d = __fdiv_rn(num, isnan(den) ? den : fmaxf(den, 1.f));
  return lvl == 0 ? d : __fmul_rn(d, static_cast<float>(1 << lvl));
}

// correlative.lookup_cascade for one pose: the distance from the finest
// level whose window holds the pose (the coarsest where none does), and in
// *escape whether it left the finest level's window
__device__ float cascade(const Cascade& c, int b, float px, float py,
                         float pt, bool* escape) {
  bool inside;
  float dist = lookup(c, 0, b, px, py, pt, &inside);
  *escape = !inside;
  for (int lvl = 1; lvl < c.levels && !inside; ++lvl)
    dist = lookup(c, lvl, b, px, py, pt, &inside);
  return dist;
}

// poses f32 (n, 3), row i looking up volume row i / per_volume; dist f32
// (n); escape u8 (n) or null
__global__ void __launch_bounds__(THREADS)
    vol_lookup_kernel(const Cascade c, const float* __restrict__ poses, int n,
                      int per_volume, float* __restrict__ dist,
                      uint8_t* __restrict__ escape) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = poses + 3 * static_cast<size_t>(i);
  bool esc;
  dist[i] = cascade(c, i / per_volume, p[0], p[1], p[2], &esc);
  if (escape != nullptr) escape[i] = esc ? 1 : 0;
}

// est f32 (3); offs f32 (k, 3), k <= blockDim.x; REFINE_PASSES times: the
// candidates est + offs, their cascade distances, est := the first minimum
// (the first NaN where there is one); out f32 (3)
__global__ void __launch_bounds__(MAX_CANDIDATES)
    vol_refine_kernel(const Cascade c, const float* __restrict__ est_in,
                      const float* __restrict__ offs, int k,
                      float* __restrict__ est_out) {
  __shared__ float cand[MAX_CANDIDATES][3];
  __shared__ float dist[MAX_CANDIDATES];
  __shared__ float est[3];
  const int tid = threadIdx.x;
  if (tid < 3) est[tid] = est_in[tid];
  __syncthreads();
  for (int pass = 0; pass < REFINE_PASSES; ++pass) {
    if (tid < k) {
      const float* o = offs + 3 * tid;
      const float x = __fadd_rn(est[0], o[0]);
      const float y = __fadd_rn(est[1], o[1]);
      const float t = __fadd_rn(est[2], o[2]);
      cand[tid][0] = x;
      cand[tid][1] = y;
      cand[tid][2] = t;
      bool esc;
      dist[tid] = cascade(c, 0, x, y, t, &esc);
    }
    __syncthreads();
    if (tid == 0) {
      // torch.argmin: the first NaN, else the first minimum
      int best = 0;
      float v = dist[0];
      for (int j = 1; j < k && !isnan(v); ++j) {
        if (isnan(dist[j]) || dist[j] < v) {
          best = j;
          v = dist[j];
        }
      }
      est[0] = cand[best][0];
      est[1] = cand[best][1];
      est[2] = cand[best][2];
    }
    __syncthreads();
  }
  if (tid < 3) est_out[tid] = est[tid];
}

bool make_cascade(Cascade* c, const void* const* scores,
                  const void* const* counts, const void* const* bases,
                  const float* ipixel, const float* theta_step, int levels,
                  int T, int W, int half) {
  if (levels < 1 || levels > MAX_LEVELS || T < 1 || W < 1 || half < 0)
    return false;
  *c = Cascade{};
  for (int l = 0; l < levels; ++l)
    c->level[l] = Level{static_cast<const float*>(scores[l]),
                        static_cast<const float*>(counts[l]),
                        static_cast<const float*>(bases[l]), ipixel[l],
                        theta_step[l]};
  c->levels = levels;
  c->T = T;
  c->W = W;
  c->half = half;
  return true;
}

}  // namespace

// Per level (arrays of `levels`, finest first): scores and counts f32
// (B,T,W,W), base f32 (B,3), 1/pixel, theta step; then poses f32 (n,3),
// row i looking up volume row i / per_volume; dist f32 (n); escape u8 (n)
// or null. The wrapper (ops/cuda_vol_lookup.py) checks every shape and
// type.
extern "C" int slam_vol_lookup(const void* const* scores,
                               const void* const* counts,
                               const void* const* bases, const float* ipixel,
                               const float* theta_step, int levels, int T,
                               int W, int half, const void* poses, int n,
                               int per_volume, void* dist, void* escape,
                               void* stream) {
  Cascade c;
  if (!make_cascade(&c, scores, counts, bases, ipixel, theta_step, levels, T,
                    W, half) ||
      n < 1 || per_volume < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  vol_lookup_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const float*>(poses), n, per_volume,
      static_cast<float*>(dist), static_cast<uint8_t*>(escape));
  return static_cast<int>(cudaGetLastError());
}

// The cascade as slam_vol_lookup's (B = 1); est f32 (3), offs f32 (k,3),
// 1 <= k <= 1024; out f32 (3).
extern "C" int slam_vol_refine(const void* const* scores,
                               const void* const* counts,
                               const void* const* bases, const float* ipixel,
                               const float* theta_step, int levels, int T,
                               int W, int half, const void* est,
                               const void* offs, int k, void* out,
                               void* stream) {
  Cascade c;
  if (!make_cascade(&c, scores, counts, bases, ipixel, theta_step, levels, T,
                    W, half) ||
      k < 1 || k > MAX_CANDIDATES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;
  vol_refine_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const float*>(est), static_cast<const float*>(offs), k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
