// K3: one call of the correlative scan matcher (ops/matching.fast_match)
// as one launch.
//
// Replaces no TPU kernel: the JAX package leaves fast_match to XLA, which
// fuses it. On the card the plain PyTorch version is about 118 small
// kernels a call (candidate grid, trig32 polynomial and quadrant selects,
// projection, roundf, bounds test, gather, sums, argmin, counts, the last
// candidate's cumsum and scatter), each on a (C, N) tensor or smaller, so
// inside a captured step the call costs its kernels' launch latencies, not
// their work.
//
// What bounds it on the H100: at the fidelity shape (C = 27 candidates,
// N = 1079 beams, fields of 200^2 and 400^2) the work is 29,133 gathers
// from a field that K1 has just written (160-640 KB, in L2), about 15 KB of
// scan and outputs: well under a microsecond of bytes or operations. What
// is left is one launch and a chain of dependent steps, each bound by one
// SM's issue rate and its L1's rate of scattered gathers (one block doing
// all of it took 13-16 us a call against the cluster's 10-10.5, and cost
// a fidelity replay 1-7% of its scans a second). So the design is one
// thread block cluster of one block a heading (2 wr + 1 blocks, at most 8,
// on neighbouring SMs), each doing its heading's share in shared memory:
//
// - every block reads the scan (in pixels), the (2 wr + 1) headings'
//   sin/cos (core/trig32.sincos32) and every candidate's x, y and its
//   offset from the grid's origin;
// - for each of its headings and each beam the rotated beam
//   (matching.project_scan), then for each x offset the beam's column and
//   for each y offset its row, rounded as roundf_like does, tested against
//   the bounds (cx > 1) & (cx < n_cols) & valid and (cy > 1) &
//   (cy < n_rows), and stored as the clamped gather index or -1: two int16
//   tables of nt * N entries a heading (6.5 KB at +-1, 10.8 KB at +-2 for
//   N = 1079);
// - its (candidate, 256-beam segment) units split into one contiguous run
//   a warp; a lane issues its eight gathers of a unit before it uses any,
//   counts a beam whose two entries are both >= 0, turns the value into its
//   lattice code k = value * 2^10 and sums codes and hits in int32; a
//   warp's sums go to the candidate's shared totals with one shared atomic
//   each;
// - one warp of each block takes the first minimum of its candidates'
//   scores (theta, then tx, then ty; the window penalty added after the
//   sum as fast_match adds it), NaN first as torch.argmin takes it;
// - after the cluster's barrier one warp of block 0 reads the blocks'
//   minima through distributed shared memory and takes the first of them,
//   while the block of the last heading compacts the last candidate's hits
//   (kept in shared memory by the warps that gathered them) by a
//   block-wide prefix count (core/sensor.compact and scatter_rows) and
//   writes its mask as it is.
//
// Exactness: every operation of the plain version is repeated in the same
// order in float32 (the build passes --fmad=false, so no multiply and add
// are contracted into an FMA); roundf_like is trunc(x + sign(x) * 0.5),
// not C's roundf. K1's fields lie on the 2^-10 lattice, so a candidate's
// sum is its non-negative integer codes' sum times 2^-10; while that sum
// is below 2^24 every partial sum torch forms, in whatever order, is exact
// in float32 and equals the integer sum. A gathered value that is not a
// non-negative code, or a candidate whose codes reach 2^24 (the sums
// saturate there), poisons that candidate's score with NaN instead of
// rounding.
//
// Everything is read from device memory (pose, origin, n_rows, n_cols), so
// the launch needs no host sync and a CUDA graph can hold it, in the
// captured steps' conditional arms too.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "trig32.cuh"   // sincos32, roundf_like

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;     // blocks of a portable cluster
constexpr int PER_LANE = 8;        // gathers a lane has in flight at once
constexpr int SEG = 32 * PER_LANE; // beams of one (candidate, segment) unit
constexpr int EXACT = 1 << 24;     // sums of codes below it are exact in f32
constexpr unsigned FULL = 0xffffffffu;

// the 1-based cell of a projected coordinate: roundf_like, to int32 as
// torch's .to(torch.int32) converts (saturating), then + 1 (wrapping)
__device__ __forceinline__ int cell_of(float v) {
  return static_cast<int>(static_cast<unsigned>(
      static_cast<int>(roundf_like(v))) + 1u);
}

// torch.argmin's order: a NaN before any number, then the lower score,
// then the lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a < b;
}

__global__ void __launch_bounds__(THREADS) scan_match_kernel(
    const float* __restrict__ metric, int S, const int* __restrict__ n_rows_p,
    const int* __restrict__ n_cols_p, const float* __restrict__ origin,
    float ipixel, const float* __restrict__ x, const float* __restrict__ y,
    const uint8_t* __restrict__ valid, int N, const float* __restrict__ pose,
    float step_t, float step_r, int wt, int wr, float penalty,
    float* __restrict__ pose_out, float* __restrict__ score_out,
    int* __restrict__ count_out, float* __restrict__ last_hits,
    uint8_t* __restrict__ last_inb) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nt = 2 * wt + 1;
  const int nr = 2 * wr + 1;
  const int NN = nt * nt;                      // candidates a heading
  const int C = nr * NN;
  const int nh_max = (nr + R - 1) / R;         // headings a block, at most
  const int nh = (nr - rank + R - 1) / R;      // this block's: rank + R k
  int* s_sum = reinterpret_cast<int*>(smem);   // C: codes a candidate
  int* s_cnt = s_sum + C;                      // C: hits a candidate
  int* s_bad = s_cnt + C;                      // C: off-lattice flags
  int* s_scan = s_bad + C;                     // WARPS + 1
  int* s_ext = s_scan + WARPS + 1;             // n_rows, n_cols
  int* s_best = s_ext + 2;                     // the block's first minimum:
                                               // score bits, index, count
  float* s_tx = reinterpret_cast<float*>(s_best + 3);  // nt each
  float* s_ty = s_tx + nt;
  float* s_offx = s_ty + nt;
  float* s_offy = s_offx + nt;
  float* s_th = s_offy + nt;                   // nr each
  float* s_sin = s_th + nr;
  float* s_cos = s_sin + nr;
  float* s_px = s_cos + nr;                    // N each: the scan in pixels
  float* s_py = s_px + N;
  float* s_last = s_py + N;                    // N: the last candidate's hits
  int16_t* tab_x = reinterpret_cast<int16_t*>(s_last + N);  // nh_max*nt*N
  int16_t* tab_y = tab_x + nh_max * nt * N;               // nh_max*nt*N
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(tab_y + nh_max * nt * N);  // N

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // -- every input but the field, read once: the scan in pixels
  // (project_scan's px, py), the candidates' coordinates
  // (matching.candidate_grid_ref) and offsets (project_scan's offx, offy),
  // each heading's sin and cos
  for (int b = tid; b < N; b += THREADS) {
    s_px[b] = x[b] * ipixel;
    s_py[b] = y[b] * ipixel;
    s_ok[b] = valid[b];
  }
  if (tid == 0) {
    s_ext[0] = *n_rows_p;
    s_ext[1] = *n_cols_p;
  }
  for (int c = tid; c < C; c += THREADS) {
    s_sum[c] = 0;
    s_cnt[c] = 0;
    s_bad[c] = 0;
  }
  for (int i = tid; i < nt; i += THREADS) {
    const float o = static_cast<float>(i - wt);
    const float tx = pose[0] + o * step_t;
    const float ty = pose[1] + o * step_t;
    s_tx[i] = tx;
    s_ty[i] = ty;
    s_offx[i] = (tx - origin[0]) * ipixel;
    s_offy[i] = (ty - origin[1]) * ipixel;
  }
  for (int h = tid; h < nr; h += THREADS) {
    const float th = pose[2] + static_cast<float>(h - wr) * step_r;
    s_th[h] = th;
    sincos32(th, &s_sin[h], &s_cos[h]);
  }
  __syncthreads();

  // -- the gather tables of this block's headings: a beam's clamped column
  // under (heading, x offset), -1 where it fails its half of the bounds
  // test or is invalid; its clamped row under (heading, y offset), -1
  // where it fails the other
  const int n_rows = s_ext[0];
  const int n_cols = s_ext[1];
  for (int k = tid; k < nh * N; k += THREADS) {
    const int hl = k / N;                      // the block's own index
    const int b = k - hl * N;
    const int h = rank + R * hl;
    const float px = s_px[b];
    const float py = s_py[b];
    const float st = s_sin[h], ct = s_cos[h];
    const float sx = px * ct + py * st;
    const float sy = (-px) * st + py * ct;
    const bool ok = s_ok[b] != 0;
    for (int i = 0; i < nt; ++i) {
      const int cx = cell_of(sx + s_offx[i]);
      const int cy = cell_of(sy + s_offy[i]);
      tab_x[(hl * nt + i) * N + b] = static_cast<int16_t>(
          ok && cx > 1 && cx < n_cols ? min(max(cx - 1, 0), S - 1) : -1);
      tab_y[(hl * nt + i) * N + b] = static_cast<int16_t>(
          cy > 1 && cy < n_rows ? min(max(cy - 1, 0), S - 1) : -1);
    }
  }
  __syncthreads();

  // -- the sums of codes and hits of this block's candidates; a warp owns
  // one contiguous run of (candidate, segment) units and flushes its sums
  // when the candidate changes
  {
    const int nseg = (N + SEG - 1) / SEG;
    const int units = nh * NN * nseg;
    const int per = (units + WARPS - 1) / WARPS;
    const int u_end = min(units, (warp + 1) * per);
    int cur = -1, sum = 0, cnt = 0;
    unsigned bad = 0;
    for (int u = warp * per; u < u_end; ++u) {
      const int cl = u / nseg;                 // the block's own candidate
      const int seg = u - cl * nseg;
      const int hl = cl / NN;
      const int i = (cl / nt) % nt;
      const int j = cl % nt;
      const int c = (rank + R * hl) * NN + i * nt + j;
      if (c != cur) {
        if (cur >= 0) {
          sum = __reduce_add_sync(FULL, sum);
          cnt = __reduce_add_sync(FULL, cnt);
          bad = __reduce_or_sync(FULL, bad);
          if (lane == 0) {
            atomicAdd(&s_sum[cur], min(sum, EXACT));
            atomicAdd(&s_cnt[cur], cnt);
            atomicOr(&s_bad[cur], static_cast<int>(bad));
          }
          sum = cnt = 0;
          bad = 0;
        }
        cur = c;
      }
      const int16_t* row_x = tab_x + (hl * nt + i) * N;
      const int16_t* row_y = tab_y + (hl * nt + j) * N;
      // every gather issued before the first is used: a miss reads cell 0
      // and is not counted
      int at[PER_LANE];
      bool hit[PER_LANE];
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        const int b = seg * SEG + lane + 32 * q;
        const int ix = b < N ? row_x[b] : -1;
        const int iy = b < N ? row_y[b] : -1;
        hit[q] = (ix | iy) >= 0;
        at[q] = hit[q] ? iy * S + ix : 0;
      }
      float val[PER_LANE];
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) val[q] = __ldg(metric + at[q]);
      if (c == C - 1) {   // kept for the compaction, as hits[-1] holds them
#pragma unroll
        for (int q = 0; q < PER_LANE; ++q) {
          const int b = seg * SEG + lane + 32 * q;
          if (b < N) s_last[b] = hit[q] ? val[q] : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        if (hit[q]) {
          const float f = val[q] * 1024.0f;
          const int code = static_cast<int>(f);
          bad |= static_cast<float>(code) != f || code < 0;
          sum = min(sum + min(max(code, 0), EXACT), EXACT);
          ++cnt;
        }
      }
    }
    if (cur >= 0) {
      sum = __reduce_add_sync(FULL, sum);
      cnt = __reduce_add_sync(FULL, cnt);
      bad = __reduce_or_sync(FULL, bad);
      if (lane == 0) {
        atomicAdd(&s_sum[cur], min(sum, EXACT));
        atomicAdd(&s_cnt[cur], cnt);
        atomicOr(&s_bad[cur], static_cast<int>(bad));
      }
    }
  }
  __syncthreads();   // the block's sums are in

  // -- the first minimum of this block's scores (theta, then tx, then ty:
  // global candidate order; the window penalty added after the sum as
  // fast_match adds it; a NaN first, as torch.argmin takes it)
  if (warp == 0) {
    const bool penalize = wt > 1 || wr > 1;
    float best = 0.0f;
    int bi = C;   // none yet
    for (int cl = lane; cl < nh * NN; cl += 32) {
      const int h = rank + R * (cl / NN);
      const int i = (cl / nt) % nt;
      const int j = cl % nt;
      const int c = h * NN + i * nt + j;
      float s = s_bad[c] || s_sum[c] >= EXACT
                    ? NAN : static_cast<float>(s_sum[c]) * 0x1p-10f;
      if (penalize) {
        const float er = fmaxf(fabsf(static_cast<float>(h - wr)) - 1.0f, 0.0f);
        const float ex = fmaxf(fabsf(static_cast<float>(i - wt)) - 1.0f, 0.0f);
        const float ey = fmaxf(fabsf(static_cast<float>(j - wt)) - 1.0f, 0.0f);
        s = s + penalty * ((er + ex) + ey);
      }
      if (bi == C || before(s, c, best, bi)) {
        best = s;
        bi = c;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (oi < C && (bi == C || before(os, oi, best, bi))) {
        best = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_best[0] = __float_as_int(best);
      s_best[1] = bi;
      s_best[2] = bi < C ? s_cnt[bi] : 0;
    }
  }

  // -- block 0 takes the first of the blocks' minima through distributed
  // shared memory once the cluster's barrier has published them
  cluster.sync();
  if (rank == 0 && warp == 0) {
    float best = 0.0f;
    int bi = C, cnt = 0;
    if (lane < R) {
      const int* theirs = cluster.map_shared_rank(s_best, lane);
      best = __int_as_float(theirs[0]);
      bi = theirs[1];
      cnt = theirs[2];
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      const int oc = __shfl_xor_sync(FULL, cnt, o);
      if (oi < C && (bi == C || before(os, oi, best, bi))) {
        best = os;
        bi = oi;
        cnt = oc;
      }
    }
    if (lane == 0) {
      pose_out[0] = s_tx[(bi / nt) % nt];
      pose_out[1] = s_ty[bi % nt];
      pose_out[2] = s_th[bi / NN];
      *score_out = best;
      *count_out = cnt;
    }
  }

  // -- meanwhile the block of the last heading compacts the last
  // candidate's hits: a thread owns a run of consecutive beams; the
  // block's exclusive prefix of their hit counts gives each hit its slot
  if (rank == (nr - 1) % R) {
    const int hl = (nr - 1) / R;
    const int16_t* last_x = tab_x + (hl * nt + nt - 1) * N;
    const int16_t* last_y = tab_y + (hl * nt + nt - 1) * N;
    const int ipt = (N + THREADS - 1) / THREADS;
    const int b0 = min(N, tid * ipt);
    const int b1 = min(N, b0 + ipt);
    int mine = 0;
    for (int b = b0; b < b1; ++b) mine += (last_x[b] | last_y[b]) >= 0;
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = s_scan[lane];
      int wi = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += t;
      }
      s_scan[lane] = wi - w;
      if (lane == 31) s_scan[WARPS] = wi;
    }
    __syncthreads();
    int pos = s_scan[warp] + incl - mine;
    for (int b = b0; b < b1; ++b) {
      const bool hit = (last_x[b] | last_y[b]) >= 0;
      last_inb[b] = hit;
      if (hit) last_hits[pos++] = s_last[b];
    }
    for (int k = s_scan[WARPS] + tid; k < N; k += THREADS) last_hits[k] = 0.0f;
  }
  // no block leaves while block 0 may still read its shared memory
  cluster.sync();
}

// The cluster's blocks: one a heading, at most a portable cluster's
int cluster_blocks(int wr) {
  return 2 * wr + 1 < MAX_CLUSTER ? 2 * wr + 1 : MAX_CLUSTER;
}

// A block's shared memory (ops/cuda_scan_match.py::smem_bytes)
size_t smem_bytes(int wt, int wr, int N) {
  const size_t nt = 2 * wt + 1, nr = 2 * wr + 1;
  const size_t R = cluster_blocks(wr);
  const size_t nh = (nr + R - 1) / R;
  return 4 * (3 * nr * nt * nt + WARPS + 6 + 4 * nt + 3 * nr + 3 * N) +
         2 * 2 * nh * nt * static_cast<size_t>(N) + N;
}

}  // namespace

// metric f32 (S,S); n_rows, n_cols i32*; origin f32 (2); ipixel; x, y f32
// (N); valid u8 (N); pose f32 (3); the steps and windows; the penalty
// (added where a window exceeds 1); the outputs pose f32 (3), score f32
// (), best count i32 (), last hits f32 (N), last mask u8 (N). The wrapper
// (ops/cuda_scan_match.py) checks every shape and type.
extern "C" int slam_scan_match(
    const void* metric, int S, const void* n_rows, const void* n_cols,
    const void* origin, float ipixel, const void* x, const void* y,
    const void* valid, int N, const void* pose, float step_t, float step_r,
    int wt, int wr, float penalty, void* pose_out,
    void* score_out, void* count_out, void* last_hits, void* last_inb,
    void* stream) {
  if (wt < 0 || wr < 0 || N < 0 || S < 1 || S > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = smem_bytes(wt, wr, N);
  // raised before the first launch that needs it: the default limit is
  // 48 KB
  static size_t configured = 48 * 1024;
  if (shmem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = shmem;
  }
  // one cluster of blocks, one a heading, on neighbouring SMs
  const int R = cluster_blocks(wr);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(R);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = shmem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, scan_match_kernel, static_cast<const float*>(metric), S,
      static_cast<const int*>(n_rows), static_cast<const int*>(n_cols),
      static_cast<const float*>(origin), ipixel, static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const uint8_t*>(valid), N,
      static_cast<const float*>(pose), step_t, step_r, wt, wr, penalty,
      static_cast<float*>(pose_out), static_cast<float*>(score_out),
      static_cast<int*>(count_out), static_cast<float*>(last_hits),
      static_cast<uint8_t*>(last_inb));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
