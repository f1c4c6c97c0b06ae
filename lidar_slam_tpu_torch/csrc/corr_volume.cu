// K2: scan-match correlation volume, by direct gather.
//
// Replaces the TPU kernel lidar_slam_tpu/ops/pallas_match.py::correlate_volume
// (_corr_kernel), fed there by ops/correlative.py::_volume_pallas. The TPU
// form scatters the beams into a bf16 one-hot histogram and correlates it
// with the whole masked field, because TPU gathers and scatters are slow.
// Here the semantics are computed directly:
//
//   scores[t,dy,dx] = sum_n valid[n] * ok(r,c) * metric[r, c],
//   r = cy0[t,n] + dy - half,  c = cx0[t,n] + dx - half,
//   ok(r,c) = 1 <= r < min(n_rows-1, S)  and  1 <= c < min(n_cols-1, S)
//
// (the reference bounds test main.c:512; cells beyond the fixed S x S array
// read 0, as in the Pallas padding). For the museum particle filter this is
// T*N*W^2 = 7*1079*169 = 1.3 M gathers against about 189 M MACs for the
// histogram correlation.
//
// Design: one block per (chunk of CHUNK beams, theta bin, batch element),
// W*W threads; the chunk's base cells are staged in shared memory, each
// thread sums its (dy, dx) over the chunk in a register and adds it to the
// output with one atomicAdd. Neighbouring dx threads read neighbouring field
// addresses. Every addend of an EDT field lies on the 2^-10 lattice and
// every partial sum stays below 2^14, so the f32 atomics are exact in any
// order and the result equals the plain version bit for bit. The launcher
// zeroes the output on the same stream first. n_rows/n_cols are read from
// device memory, so the caller needs no host sync.
//
// The batch axis (blockIdx.z) serves loop closure, which matches one scan
// against B old keyframes' fields at once: metric (B,S,S), cx0/cy0 (B,T,N),
// valid (B,N), scores (B,T,W,W), one launch for the whole batch. The
// particle filter calls it with B = 1.
//
// What bounds it on the H100: about 1.3 M 4-byte gathers from a 640 KB field
// that sits in L2, i.e. L2 latency and the launch, not HBM bandwidth or the
// FP32 ALUs. A closure batch (B=8, T=21, half=14 on 256^2 fields, 2 MB) is
// 8*21*1079*841 = 152 M gathers: there the gathers themselves bound it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;

__global__ void corr_volume_kernel(const float* __restrict__ metric, int S,
                                   const int* __restrict__ cx0,
                                   const int* __restrict__ cy0,
                                   const uint8_t* __restrict__ valid, int N,
                                   const int* __restrict__ n_rows_p,
                                   const int* __restrict__ n_cols_p, int half,
                                   float* __restrict__ scores) {
  __shared__ int s_c[CHUNK];
  __shared__ int s_r[CHUNK];
  __shared__ int s_ok[CHUNK];
  const int W = 2 * half + 1;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * CHUNK;
  const int T = gridDim.y;
  metric += static_cast<size_t>(b) * S * S;
  cx0 += static_cast<size_t>(b) * T * N;
  cy0 += static_cast<size_t>(b) * T * N;
  valid += static_cast<size_t>(b) * N;
  scores += static_cast<size_t>(b) * T * W * W;
  const int count = min(CHUNK, N - n0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int n = n0 + i;
    s_c[i] = cx0[t * N + n] - half;
    s_r[i] = cy0[t * N + n] - half;
    s_ok[i] = valid[n] != 0;
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= W * W) return;
  const int dy = tid / W;
  const int dx = tid % W;
  const int row_hi = min(*n_rows_p - 1, S);
  const int col_hi = min(*n_cols_p - 1, S);
  float acc = 0.0f;
  for (int i = 0; i < count; ++i) {
    const int r = s_r[i] + dy;
    const int c = s_c[i] + dx;
    if (s_ok[i] && r >= 1 && r < row_hi && c >= 1 && c < col_hi) {
      acc = __fadd_rn(acc, metric[static_cast<size_t>(r) * S + c]);
    }
  }
  if (acc != 0.0f) atomicAdd(&scores[(t * W + dy) * W + dx], acc);
}

}  // namespace

extern "C" int slam_corr_volume(const void* metric, int S, const void* cx0,
                                const void* cy0, const void* valid, int B,
                                int T, int N, const void* n_rows,
                                const void* n_cols, int half, void* scores,
                                void* stream) {
  const int W = 2 * half + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      scores, 0, sizeof(float) * static_cast<size_t>(B) * T * W * W, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0 || T == 0 || N == 0) return 0;
  const int threads = ((W * W + 31) / 32) * 32;
  const dim3 grid((N + CHUNK - 1) / CHUNK, T, B);
  corr_volume_kernel<<<grid, threads, 0, s>>>(
      static_cast<const float*>(metric), S, static_cast<const int*>(cx0),
      static_cast<const int*>(cy0), static_cast<const uint8_t*>(valid), N,
      static_cast<const int*>(n_rows), static_cast<const int*>(n_cols), half,
      static_cast<float*>(scores));
  return static_cast<int>(cudaGetLastError());
}
