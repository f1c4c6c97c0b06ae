// K5: one scan's intake (core/sensor.read_scan) as one launch.
//
// Replaces no TPU kernel: the JAX package's read_scan is plain jnp code,
// which XLA fuses on the TPU. On the card the plain PyTorch version is
// about 70 small kernels a scan: trig32.sincos32 of the beam-angle table
// (46: the reduction, the polynomials and the quadrant selects, each an
// elementwise kernel, recomputed every scan on the same constant table),
// then the range gate, compact's cumsum and where, and two scatter_rows
// (24). Every captured step runs it once a scan, so inside the step's graph
// it costs those nodes' launch latencies, not their work.
//
// What bounds it on the H100: at N = 1079 beams the work is 8.6 KB of
// ranges and angles read, 8.6 KB of x and y, 1 KB of mask and the size
// written (~18 KB, under 6 ns at 3.35 TB/s) and about 30 float operations
// a beam. What is left is one launch and one block-wide prefix count. So
// the design is one block of 1024 threads:
//
// - thread t owns the contiguous run of beams [t * ipt, (t + 1) * ipt),
//   ipt = ceil(N / 1024) <= PER_THREAD; it reads its ranges into registers,
//   gates them (range_min <= r <= usable_range, in float32, as torch
//   compares a float32 tensor with a Python float) and counts its kept
//   beams;
// - each warp's inclusive scan of those counts by shuffles, then warp 0's
//   scan of the warps' totals: the block's exclusive prefix is the slot of
//   the thread's first kept beam (core/sensor.compact: a kept beam goes to
//   the number of kept beams before it, so beam order is kept);
// - for each kept beam the sin and cos of its angle (trig32.cuh, the plain
//   version's operations in its order) and x = r * cos, y = r * sin at its
//   slot;
// - x and y zero from size up to N, valid[j] = j < size, and size.
//
// Exactness: each point is one float32 product of the same range and the
// same sincos32 value, and the gate the same two float32 comparisons, so
// (x, y, valid, size) are read_scan_plain's bit for bit (the build passes
// --fmad=false: no multiply and add are contracted into an FMA inside
// sincos32). A NaN or infinite range fails the gate, as in the plain
// version.
//
// Nothing is read back to the host, so a CUDA graph can hold the launch:
// every captured step runs it once a replay.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "trig32.cuh"   // sincos32

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;                    // beams a thread, at most
constexpr int MAX_BEAMS = THREADS * PER_THREAD;  // ops/cuda_scan_intake.py
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) scan_intake_kernel(
    const float* __restrict__ ranges, const float* __restrict__ angles, int N,
    float range_min, float usable_range, float* __restrict__ x,
    float* __restrict__ y, uint8_t* __restrict__ valid,
    int* __restrict__ size) {
  __shared__ int s_scan[WARPS + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ipt = (N + THREADS - 1) / THREADS;
  const int b0 = min(N, tid * ipt);
  const int b1 = min(N, b0 + ipt);

  // -- this thread's run of beams: its ranges, gated and counted
  float r[PER_THREAD];
  unsigned keep = 0;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    r[k] = 0.0f;
    if (b0 + k < b1) {
      r[k] = ranges[b0 + k];
      const bool ok = r[k] >= range_min && r[k] <= usable_range;
      keep |= static_cast<unsigned>(ok) << k;
      mine += ok;
    }
  }

  // -- the block's exclusive prefix of the counts: a warp's inclusive scan,
  // then warp 0 scans the warps' totals
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
  const int total = s_scan[WARPS];

  // -- each kept beam's point at its slot
  int pos = s_scan[warp] + incl - mine;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if ((keep >> k) & 1u) {
      float s, c;
      sincos32(angles[b0 + k], &s, &c);
      x[pos] = r[k] * c;
      y[pos] = r[k] * s;
      ++pos;
    }
  }

  // -- zeros past the kept beams, the prefix mask and the size
  for (int j = total + tid; j < N; j += THREADS) {
    x[j] = 0.0f;
    y[j] = 0.0f;
  }
  for (int j = tid; j < N; j += THREADS) valid[j] = j < total;
  if (tid == 0) *size = total;
}

}  // namespace

// ranges f32 (N); angles f32 (N); N in 1..MAX_BEAMS; the gate's float32
// bounds; the outputs x, y f32 (N), valid u8 (N), size i32 (). The wrapper
// (ops/cuda_scan_intake.py) checks every shape and type.
extern "C" int slam_scan_intake(const void* ranges, const void* angles, int N,
                                float range_min, float usable_range, void* x,
                                void* y, void* valid, void* size,
                                void* stream) {
  if (N < 1 || N > MAX_BEAMS) return static_cast<int>(cudaErrorInvalidValue);
  scan_intake_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ranges), static_cast<const float*>(angles), N,
      range_min, usable_range, static_cast<float*>(x), static_cast<float*>(y),
      static_cast<uint8_t*>(valid), static_cast<int*>(size));
  return static_cast<int>(cudaGetLastError());
}
