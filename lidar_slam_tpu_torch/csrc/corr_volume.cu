// K2: scan-match correlation volume, gathered from a tile of integer
// lattice codes in shared memory.
//
// Replaces the TPU kernel lidar_slam_tpu/ops/pallas_match.py::correlate_volume
// (_corr_kernel), fed there by ops/correlative.py::_volume_pallas. The TPU
// form scatters the beams into a bf16 one-hot histogram and correlates it
// with the whole masked field, because TPU gathers and scatters are slow.
// Here the semantics are computed directly:
//
//   scores[b,t,dy,dx] = sum_n valid[b,n] * ok(r,c) * metric[b,r,c],
//   r = cy0[b,t,n] + dy - half,  c = cx0[b,t,n] + dx - half,
//   ok(r,c) = 1 <= r < min(n_rows-1, S)  and  1 <= c < min(n_cols-1, S)
//
// (the reference bounds test main.c:512; cells beyond the fixed S x S array
// read 0, as in the Pallas padding).
//
// What bounds it on the H100: at the closure shape (B=8, T=21, half=14 on
// 256^2 fields) 151 M adds, about 2.3 us at the fp32 rate, and 4.1 MB of
// inputs, 1.2 us at the HBM rate; every add needs one gathered field cell,
// so the practical floor is the shared-memory gather rate (one 32-lane
// access a clock an SM: about 20 us for 151 M). At the particle filter's
// shape (T=7, half=6, 400^2) the work is 1 M adds, and a block's fixed chain
// (prologue, box, barriers; measured about 4 us) is what is left.
//
// Design:
// - One block per (beam chunk, batch element b) loops over all T bins, so
//   the bins share one staged tile. The wrapper sizes the chunk so the grid
//   is at most two blocks an SM (one wave) where 8 beams a block allow.
// - Prologue: the chunk's base cells at every bin and its valid flags are
//   copied into shared memory in one pass, every load unconditional and in
//   flight at once. Then each beam's thread clamps its cells into
//   [-half, row_hi + half] x [-half, col_hi + half], which moves no window
//   across the valid region's edge, so huge or garbage cells are safe. The
//   beams that are valid and whose window meets the valid region at some
//   bin are compacted into a list (their order is free: the sums below are
//   integer sums), and the same pass takes the box of their cells, the
//   first piece's box.
// - The tile is the bounding box of every live (bin, beam) window of the
//   piece, staged once as uint16 codes k = metric * 2^q. Every EDT value is
//   on the 2^-10 lattice (2^-(10+l) for a cascade level min-pooled and
//   divided by 2^l, so the wrapper passes q = 10 + l) and k <= 10 * 1024,
//   so the code is exact. Cells that fail the bounds test are staged as 0,
//   which removes the test from every gather. A value that is not an exact
//   code in 0..65535 poisons the block's sums with NaN instead of rounding.
//   The box's columns are widened to whole aligned quads, so a thread
//   stages four cells with one 16-byte load and one 8-byte shared store.
//   The staging converts and masks as it copies, so it uses plain loads
//   spread over the whole block (a cp.async or TMA copy would land raw
//   floats and need a second pass over shared memory).
// - A piece whose box exceeds the tile budget is halved along its beams,
//   down to one beam, then along its bins; the wrapper keeps the budget at
//   least one window, so every piece ends up fitting. A piece whose box is
//   sparse (more than half as many cells as the piece has gathers: beams of
//   one chunk that hit walls far apart) is halved along its beams too, so
//   no block stages a box that costs more than its gathers.
// - The tile pitch is = 32 (mod 64) codes, so the two or three rows a warp's
//   offsets span fall into different banks.
// - Each thread owns up to KPT (dy, dx) offsets per pass (more passes for
//   any window size: no limit on half from the thread count) and sums its
//   codes in int32 registers: the window origins of four beams in one
//   broadcast 16-byte read, then KPT conflict-free uint16 reads per beam.
//   The largest sum is
//   N * 10240 (11.0 M for 1079 beams) < 2^24, so its float is exact.
// - The block adds each (bin, offset) sum, times 2^-q, to the output with
//   one float atomicAdd. Every addend and partial sum is an exact lattice
//   value below 2^24 lattice units, so the atomics are exact in any order
//   and the result equals the plain version bit for bit. The launcher
//   zeroes the output on the same stream first. n_rows / n_cols are read
//   from device memory, so the caller needs no host sync.
//
// The batch axis (blockIdx.y) serves loop closure, which matches one scan
// against B old keyframes' fields at once; the particle filter calls it with
// B = 1. ("// pass: NAME" tags a pass's loop: kernel_breakdown.py times the
// kernel with that loop cut out.)

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int tile_pitch(int width) {
  return ((width + 31) / 64) * 64 + 32;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int KPT>
__global__ void __launch_bounds__(1024) corr_volume_kernel(
    const float* __restrict__ metric, int S, const int* __restrict__ cx0,
    const int* __restrict__ cy0, const uint8_t* __restrict__ valid, int T,
    int N, const int* __restrict__ n_rows_p, const int* __restrict__ n_cols_p,
    int half, int q, int chunk, int tile_cells, int vec,
    float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpad = (chunk + 3) & ~3;
  int* s_base = reinterpret_cast<int*>(smem);  // T * cpad window origins
  int* s_cy = s_base + T * cpad;               // T * chunk base cells
  int* s_cx = s_cy + T * chunk;
  int* s_live = s_cx + T * chunk;              // chunk
  uint16_t* tile = reinterpret_cast<uint16_t*>(
      s_base + ((T * cpad + 2 * T * chunk + chunk + 3) & ~3));
  __shared__ int s_count, s_box[4];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * chunk;
  const int n_here = min(chunk, N - n0);
  const int W = 2 * half + 1;
  const int WW = W * W;
  metric += static_cast<size_t>(b) * S * S;
  cx0 += static_cast<size_t>(b) * T * N + n0;
  cy0 += static_cast<size_t>(b) * T * N + n0;
  valid += static_cast<size_t>(b) * N + n0;
  scores += static_cast<size_t>(b) * T * WW;
  const int nr = *n_rows_p;
  const int nc = *n_cols_p;
  const int row_hi = nr <= 1 ? 0 : min(nr - 1, S);  // valid: 1 <= r < row_hi
  const int col_hi = nc <= 1 ? 0 : min(nc - 1, S);
  const float up = ldexpf(1.0f, q);
  const float down = ldexpf(1.0f, -q);

  // -- the chunk's base cells at every bin, raw, all loads at once; an
  // invalid beam's columns are marked INT_MIN
  for (int k = tid; k < T * n_here; k += blockDim.x) {
    const int t = k / n_here;
    const int i = k - t * n_here;
    const int cy = cy0[t * N + i];
    const int cx = cx0[t * N + i];
    const bool ok = valid[i];
    s_cy[t * chunk + i] = cy;
    s_cx[t * chunk + i] = ok ? cx : INT_MIN;
  }
  if (tid == 0) {
    s_count = 0;
    s_box[0] = INT_MAX;
    s_box[1] = INT_MIN;
    s_box[2] = INT_MAX;
    s_box[3] = INT_MIN;
  }
  __syncthreads();
  // -- clamp each beam's cells (an invalid beam's rows go to -half, where no
  // window meets the valid region), compact the live beams (their order is
  // free: integer sums) and take the box of their cells at every bin
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
  for (int i = tid; i < n_here; i += blockDim.x) {
    const bool ok = s_cx[i] != INT_MIN;
    bool live = false;
    int r0 = INT_MAX, r1 = INT_MIN, c0 = INT_MAX, c1 = INT_MIN;
    for (int t = 0; t < T; ++t) {
      const int cy = ok ? clampi(s_cy[t * chunk + i], -half, row_hi + half)
                        : -half;
      const int cx = clampi(s_cx[t * chunk + i], -half, col_hi + half);
      s_cy[t * chunk + i] = cy;
      s_cx[t * chunk + i] = cx;
      live |= cy + half >= 1 && cy - half < row_hi && cx + half >= 1 &&
              cx - half < col_hi;
      r0 = min(r0, cy);
      r1 = max(r1, cy);
      c0 = min(c0, cx);
      c1 = max(c1, cx);
    }
    if (live) {
      s_live[atomicAdd(&s_count, 1)] = i;
      rmin = min(rmin, r0);
      rmax = max(rmax, r1);
      cmin = min(cmin, c0);
      cmax = max(cmax, c1);
    }
  }
  bool have_box = true;
  int i0 = 0, i1 = 0, t0 = 0, t1 = T;
  while (true) {
    if (!have_box) {
      // -- bounding box of the piece's base cells
      if (tid == 0) {
        s_box[0] = INT_MAX;
        s_box[1] = INT_MIN;
        s_box[2] = INT_MAX;
        s_box[3] = INT_MIN;
      }
      __syncthreads();
      const int np = i1 - i0;
      const int nt = t1 - t0;
      for (int k = tid; k < np * nt; k += blockDim.x) {
        const int ti = k / np;
        const int at = (t0 + ti) * chunk + s_live[i0 + k - ti * np];
        rmin = min(rmin, s_cy[at]);
        rmax = max(rmax, s_cy[at]);
        cmin = min(cmin, s_cx[at]);
        cmax = max(cmax, s_cx[at]);
      }
    }
    rmin = warp_min(rmin);
    rmax = warp_max(rmax);
    cmin = warp_min(cmin);
    cmax = warp_max(cmax);
    if (lane == 0) {
      atomicMin(&s_box[0], rmin);
      atomicMax(&s_box[1], rmax);
      atomicMin(&s_box[2], cmin);
      atomicMax(&s_box[3], cmax);
    }
    __syncthreads();
    if (have_box) {  // the first piece: every live beam at every bin
      i1 = s_count;
      have_box = false;
    }
    if (i0 >= i1) break;
    rmin = cmin = INT_MAX;
    rmax = cmax = INT_MIN;
    const int np = i1 - i0;
    const int nt = t1 - t0;
    // rows br0 .. br0 + rows - 1; columns from bc0, a multiple of 4, over
    // a width of whole quads
    const int br0 = s_box[0] - half;
    const int bc0 = (s_box[2] - half) & ~3;
    const int rows = s_box[1] - s_box[0] + W;
    const int width = (s_box[3] + half + 1 - bc0 + 3) & ~3;
    __syncthreads();  // s_box is reset by the next piece
    const int pitch = tile_pitch(width);
    // halve a piece whose box overflows the tile, or whose box holds more
    // than half as many cells as the piece has gathers (staging a cell, a
    // global load and a conversion, costs about two gathers)
    if (static_cast<long long>(rows) * pitch > tile_cells ||
        (np > 1 && 2LL * rows * width > static_cast<long long>(np) * nt * WW)) {
      if (np > 1) {
        i1 = i0 + np / 2;
      } else {
        t1 = t0 + nt / 2;
      }
      continue;
    }

    // -- stage the box as codes, four cells a thread and a 16-byte load
    // where the field allows, every load of the block in flight at once;
    // cells failing the bounds test are 0
    bool bad = false;
    const int quads = width >> 2;
#pragma unroll 4
    for (int k = tid; k < rows * quads; k += blockDim.x) {  // pass: stage
      const int r = k / quads;
      const int c = (k - r * quads) << 2;
      const int gr = br0 + r;
      const int gc = bc0 + c;
      uint32_t code[4] = {0u, 0u, 0u, 0u};
      if (gr >= 1 && gr < row_hi) {
        const float* src = metric + static_cast<size_t>(gr) * S + gc;
        float v[4];
        if (vec && gc >= 0 && gc + 4 <= S) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = gc + j >= 0 && gc + j < S ? src[j] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gc + j >= 1 && gc + j < col_hi) {
            const float u = __fmul_rn(v[j], up);
            const int k2 = __float2int_rz(u);
            bad |= !(k2 >= 0 && k2 <= 65535 && __int2float_rn(k2) == u);
            code[j] = static_cast<uint32_t>(k2) & 0xFFFFu;
          }
        }
      }
      *reinterpret_cast<uint2*>(tile + r * pitch + c) =
          make_uint2(code[0] | (code[1] << 16), code[2] | (code[3] << 16));
    }
    // -- each (bin, beam)'s window origin in the tile, rows of bins
    // padded to 4 origins so they read as int4
    const int npp = (np + 3) & ~3;
    for (int k = tid; k < np * nt; k += blockDim.x) {
      const int ti = k / np;
      const int ii = k - ti * np;
      const int at = (t0 + ti) * chunk + s_live[i0 + ii];
      s_base[ti * npp + ii] =
          (s_cy[at] - half - br0) * pitch + (s_cx[at] - half - bc0);
    }
    const bool poisoned = __syncthreads_or(bad);

    // -- integer sums per owned offset, one atomic per (bin, offset)
    for (int o0 = 0; o0 < WW; o0 += blockDim.x * KPT) {
      int off[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int o = o0 + tid + j * blockDim.x;
        off[j] = o < WW ? (o / W) * pitch + (o % W) : 0;
      }
      for (int ti = 0; ti < nt; ++ti) {
        int acc[KPT];
#pragma unroll
        for (int j = 0; j < KPT; ++j) acc[j] = 0;
        const int* bases = s_base + ti * npp;
        int ii = 0;
        for (; ii + 4 <= np; ii += 4) {  // pass: gather
          const int4 bb = *reinterpret_cast<const int4*>(bases + ii);
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            acc[j] += tile[bb.x + off[j]] + tile[bb.y + off[j]] +
                      tile[bb.z + off[j]] + tile[bb.w + off[j]];
          }
        }
        for (; ii < np; ++ii) {  // pass: gather
          const int base = bases[ii];
#pragma unroll
          for (int j = 0; j < KPT; ++j) acc[j] += tile[base + off[j]];
        }
        float* out = scores + static_cast<size_t>(t0 + ti) * WW;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int o = o0 + tid + j * blockDim.x;
          if (o < WW && (acc[j] != 0 || poisoned)) {
            atomicAdd(out + o, poisoned ? __int_as_float(0x7fc00000)
                                        : __fmul_rn(__int2float_rn(acc[j]),
                                                    down));
          }
        }
      }
    }
    __syncthreads();  // the next piece restages the tile and the origins

    if (t1 < T) {  // a single beam split over its bins: its next bins
      t0 = t1;
      t1 = T;
    } else {
      i0 = i1;
      i1 = s_count;
      t0 = 0;
      t1 = T;
    }
    if (i0 >= i1) break;
  }
}

// Shared memory of a block: the window origins (bins padded to 4), the
// clamped base cells and the live list, padded to 16 bytes, then the tile
// (ops/cuda_match.py::smem_bytes is the same formula).
size_t smem_bytes(int T, int chunk, int tile_cells) {
  const size_t cpad = (chunk + 3) & ~3;
  const size_t ints = T * cpad + 2 * static_cast<size_t>(T) * chunk + chunk;
  return sizeof(int) * ((ints + 3) & ~static_cast<size_t>(3)) +
         sizeof(uint16_t) * static_cast<size_t>(tile_cells);
}

// Codes of the largest tile one window can need: W rows of a width rounded
// out to whole quads (ops/cuda_match.py::window_cells)
int window_cells(int W) {
  const int width = (W + 6) & ~3;
  return W * (((width + 31) / 64) * 64 + 32);
}

template <int KPT>
int launch_kpt(const float* metric, int S, const int* cx0, const int* cy0,
               const uint8_t* valid, int B, int T, int N, const int* n_rows,
               const int* n_cols, int half, int q, int chunk, int tile_cells,
               int vec, float* scores, int threads, cudaStream_t s) {
  // raised before the first launch: the default limit of 48 KB also
  // counts the kernel's static shared memory
  static size_t configured = 0;
  const size_t shmem = smem_bytes(T, chunk, tile_cells);
  if (shmem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_volume_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = shmem;
  }
  const dim3 grid((N + chunk - 1) / chunk, B);
  corr_volume_kernel<KPT><<<grid, threads, shmem, s>>>(
      metric, S, cx0, cy0, valid, T, N, n_rows, n_cols, half, q, chunk,
      tile_cells, vec, scores);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk: beams per block; tile_cells: the tile budget in codes, at least
// one window (W rows of pitch(W)). Both are chosen by the wrapper
// (ops/cuda_match.py), which also checks every shape and type.
extern "C" int slam_corr_volume(const void* metric, int S, const void* cx0,
                                const void* cy0, const void* valid, int B,
                                int T, int N, const void* n_rows,
                                const void* n_cols, int half, int q,
                                int chunk, int tile_cells, void* scores,
                                void* stream) {
  const int W = 2 * half + 1;
  const int WW = W * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      scores, 0, sizeof(float) * static_cast<size_t>(B) * T * WW, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0 || T == 0 || N == 0) return 0;
  if (chunk < 1 || half < 0 || tile_cells < window_cells(W))
    return static_cast<int>(cudaErrorInvalidValue);
  // offsets a thread owns: the most of 4, 2, 1 that still gives 128 threads
  int kpt = 4;
  while (kpt > 1 && (WW + kpt - 1) / kpt < 128) kpt >>= 1;
  const int threads = min(1024, ((WW + kpt - 1) / kpt + 31) / 32 * 32);
  const float* m = static_cast<const float*>(metric);
  const int* x = static_cast<const int*>(cx0);
  const int* y = static_cast<const int*>(cy0);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int* nr = static_cast<const int*>(n_rows);
  const int* nc = static_cast<const int*>(n_cols);
  float* out = static_cast<float*>(scores);
  // 16-byte loads of the field where its rows keep 16-byte alignment
  const int vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  switch (kpt) {
    case 4:
      return launch_kpt<4>(m, S, x, y, v, B, T, N, nr, nc, half, q, chunk,
                           tile_cells, vec, out, threads, s);
    case 2:
      return launch_kpt<2>(m, S, x, y, v, B, T, N, nr, nc, half, q, chunk,
                           tile_cells, vec, out, threads, s);
    default:
      return launch_kpt<1>(m, S, x, y, v, B, T, N, nr, nc, half, q, chunk,
                           tile_cells, vec, out, threads, s);
  }
}
