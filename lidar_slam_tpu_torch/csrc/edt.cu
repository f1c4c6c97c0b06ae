// K1: clamped Euclidean distance transform, batched over a leading axis,
// from bit-packed occupancy.
//
// Replaces the TPU kernel lidar_slam_tpu/ops/pallas_edt.py::edt_clamped_pallas
// (_edt_kernel and its row-strip twin _edt_kernel_blocked). The TPU needed the
// two variants only because of its 16 MB VMEM limit; here one kernel serves
// every grid size and batch.
//
//   d1[y,x]  = min_{|dx|<=R} (occ[y,x+dx] ? dx^2 : INF)
//   d2[y,x]  = min_{|dy|<=R} d1[y+dy,x] + dy^2
//   out[y,x] = snap(min(sqrt(d2), R)),  snap(v) = trunc(v*1024 + 0.5) / 1024
//
// What bounds it on the H100: bytes. Each cell reads 1 byte and writes 4, so
// (8,448,448) moves 8.0 MB, 2.4 us at 3.35 TB/s; a single 400^2 grid moves
// 0.8 MB and is bound by the launch.
//
// Design: a block of 512 threads owns a band of whole rows of one grid (no
// horizontal halo); the wrapper takes the fewest rows (4 to 32) that keep
// the grid to one block an SM, since fewer rows mean more halo rows to
// redo and a second wave costs a whole block's time. Three
// passes, each spread over every thread of the block so that every load of
// a pass is in flight at once:
// - Pack: the band's occupancy, with R rows of vertical halo each side, into
//   32-bit words in shared memory, one word a thread: two 16-byte loads (or
//   eight 4-byte loads, or 32 byte loads where the row's width or address
//   rules the wider ones out), packed 4 bytes to 4 bits by a compare and a
//   multiply. Cells outside the grid are free; the two words beyond either
//   end of a row are 0.
// - Row pass: the nearest occupied cell within +-R of x is a bit scan of
//   its own word and the neighbouring words (__ffs to the right, __clz to
//   the left; the second word each side only when R > 32), O(1) a cell,
//   done once for each staged cell, four cells of one word a thread; its
//   exact dx^2 (or a 16-bit INF) goes to shared memory as two cells a
//   32-bit word.
// - Column pass: a thread takes 8 cells of one output row and reads their
//   2R+1 rows of d1 (one 16-byte load a row); each tap is one Hopper DPX
//   instruction for two cells, min(d1 + dy^2, best) on 16-bit halves
//   (__viaddmin_u16x2), four independent chains. Every value is a small
//   exact integer.
// The float tail is the reference's, rounding by rounding: __fsqrt_rn
// (IEEE), fminf, and the lattice snap written with __fmul_rn / __fadd_rn so
// no FMA can merge it (the library is also built --fmad=false), once for
// every d2 the column pass can give, into a table. Occupied cells get 0
// from their own tap. Stores are float4 where the row allows.
//
// Measured on the H100 the row and the column pass are what is left: each
// is a few ALU operations a cell, and the halo rows redo the row pass.
// ("// pass: NAME" tags a pass's loop: kernel_breakdown.py times the kernel
// with that loop cut out.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 16-bit "none within R": sqrt > R, and INF_D2 + R^2 fits 16 bits
constexpr uint32_t INF_D2 = 0x2000;
constexpr int MAX_R = 64;  // two words each side of a cell's own word
constexpr int THREADS = 512;

// 4 bytes -> 4 bits, bit c set where byte c is nonzero
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  const uint32_t v = __vcmpne4(x, 0u) & 0x01010101u;
  return ((v * 0x00204081u) >> 21) & 0xFu;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | (pack4(v.y) << 4) | (pack4(v.z) << 8) |
         (pack4(v.w) << 12);
}

// cells x0 .. x0+31 of one row as a word (bit j = cell x0 + j; cells at or
// beyond W are free). mode 2: 16-byte loads (W % 16 == 0 and the grid
// 16-byte aligned); 1: 4-byte loads (W % 4 == 0, 4-byte aligned); 0: bytes.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int x0,
                                              int W, int mode) {
  uint32_t w = 0;
  if (mode == 2) {
    if (x0 < W) w = pack16(*reinterpret_cast<const uint4*>(row + x0));
    if (x0 + 16 < W)
      w |= pack16(*reinterpret_cast<const uint4*>(row + x0 + 16)) << 16;
  } else if (mode == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (x0 + 4 * i < W)
        w |= pack4(*reinterpret_cast<const uint32_t*>(row + x0 + 4 * i))
             << (4 * i);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (x0 + i < W && row[x0 + i] != 0) w |= 1u << i;
  }
  return w;
}

// d1 of cell s of word cur, given where the nearest occupied cells of the
// neighbouring words lie: pl = the free cells left of the word, nf = those
// right of it (> R where none is within reach). 32-bit scans only.
__device__ __forceinline__ uint32_t cell_d1(uint32_t cur, int s, int pl,
                                            int nf, int R) {
  const uint32_t a = cur >> s;                 // bit 0: cell x
  const uint32_t l = cur << (31 - s);          // bit 31: cell x
  const int dr = a ? __ffs(a) - 1 : 32 - s + nf;
  const int dl = l ? __clz(l) : s + 1 + pl;
  const int d = min(dl, dr);
  return d <= R ? static_cast<uint32_t>(d * d) : INF_D2;
}

__global__ void __launch_bounds__(THREADS) edt_band_kernel(
    const uint8_t* __restrict__ occ, float* __restrict__ out, int H, int W,
    int R, int band, int in_mode, int vec_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = (W + 31) >> 5;        // words a row
  const int nwp = nw + 4;              // with two zero words at each end
  const int np = 4 * ((W + 7) >> 3);   // d1 words a row, two cells each
  const int rows = band + 2 * R;       // staged rows: y0 - R .. y0+band+R-1
  uint32_t* bits = smem;
  uint32_t* d1 = smem + ((rows * nwp + 3) & ~3);
  float* snap = reinterpret_cast<float*>(d1 + rows * np);  // R*R + 2
  const int tid = threadIdx.x;
  const int y0 = blockIdx.x * band;
  const uint8_t* g = occ + static_cast<size_t>(blockIdx.y) * H * W;
  float* o = out + static_cast<size_t>(blockIdx.y) * H * W;

  // -- the float tail of every d2 the column pass can give (0 .. R*R, and
  // R*R + 1 for "beyond R"), each computed once, rounding by rounding
  for (int v = tid; v <= R * R + 1; v += THREADS) {
    const float d = fminf(__fsqrt_rn(static_cast<float>(v)),
                          static_cast<float>(R));
    const float q = truncf(__fadd_rn(__fmul_rn(d, 1024.0f), 0.5f));
    snap[v] = __fmul_rn(q, 1.0f / 1024.0f);
  }
  // Each pass splits its columns over the threads and the rows over the
  // threads left over, without a division in its loop: the thread at
  // i = tid (< per * n, or every i of the strided loop when n > THREADS)
  // takes column i % n of rows i / n, i / n + per, ...
  // -- pack: a thread takes one word column
  int per = max(1, THREADS / nwp);
  for (int i = tid; i < per * nwp; i += THREADS) {  // pass: pack
    const int k = i % nwp;
#pragma unroll 4
    for (int r = i / nwp; r < rows; r += per) {
      const int y = y0 - R + r;
      bits[r * nwp + k] =
          k >= 2 && k <= nw + 1 && y >= 0 && y < H
              ? load_word(g + static_cast<size_t>(y) * W, (k - 2) << 5, W,
                          in_mode)
              : 0u;
    }
  }
  __syncthreads();

  // -- row pass: a thread takes four cells (x .. x + 3) of one row
  const int nq = np >> 1;
  per = max(1, THREADS / nq);
  for (int i = tid; i < per * nq; i += THREADS) {  // pass: row
    const int q4 = i % nq;
    const int x = 4 * q4;
    const int k = (x >> 5) + 2;
    const int s = x & 31;  // a multiple of 4: x .. x + 3 share a word
    for (int r = i / nq; r < rows; r += per) {
      const uint32_t* wr = bits + r * nwp;
      const uint32_t cur = wr[k];
      const uint32_t prv = wr[k - 1];
      const uint32_t nxt = wr[k + 1];
      // beyond an empty neighbour, the second word each side (R > 32)
      const int pl = prv              ? __clz(prv)
                     : R > 32 && wr[k - 2] ? 32 + __clz(wr[k - 2])
                                          : 96;
      const int nf = nxt              ? __ffs(nxt) - 1
                     : R > 32 && wr[k + 2] ? 31 + __ffs(wr[k + 2])
                                          : 96;
      reinterpret_cast<uint2*>(d1 + r * np)[q4] = make_uint2(
          cell_d1(cur, s, pl, nf, R) | (cell_d1(cur, s + 1, pl, nf, R) << 16),
          cell_d1(cur, s + 2, pl, nf, R) |
              (cell_d1(cur, s + 3, pl, nf, R) << 16));
    }
  }
  __syncthreads();

  // -- column pass: a thread takes eight cells down the band's output rows
  const int y_end = min(band, H - y0);
  const int ng = np >> 2;
  const uint32_t cap = static_cast<uint32_t>(R * R + 1);
  per = max(1, THREADS / ng);
  for (int i = tid; i < per * ng; i += THREADS) {  // pass: col
    const int g8 = i % ng;
    const int x0 = 8 * g8;
    const uint4* col = reinterpret_cast<const uint4*>(d1) + g8;
    for (int yy = i / ng; yy < y_end; yy += per) {
      // staged row yy holds y0 + yy - R: the taps of output row y0 + yy
      const uint4* c = col + yy * ng;
      uint32_t best[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) best[j] = INF_D2 | (INF_D2 << 16);
#pragma unroll 7
      for (int t = 0; t <= 2 * R; ++t) {
        const uint4 v = c[t * ng];
        const uint32_t dy2 = static_cast<uint32_t>((t - R) * (t - R));
        const uint32_t dy2x2 = dy2 | (dy2 << 16);
        best[0] = __viaddmin_u16x2(v.x, dy2x2, best[0]);  // min(d1 + dy^2,
        best[1] = __viaddmin_u16x2(v.y, dy2x2, best[1]);  //     best)
        best[2] = __viaddmin_u16x2(v.z, dy2x2, best[2]);
        best[3] = __viaddmin_u16x2(v.w, dy2x2, best[3]);
      }
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = snap[min(best[j] & 0xFFFFu, cap)];
        v[2 * j + 1] = snap[min(best[j] >> 16, cap)];
      }
      float* dst = o + static_cast<size_t>(y0 + yy) * W + x0;
      if (vec_out && x0 + 7 < W) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8)
          if (x0 + c8 < W) dst[c8] = v[c8];
      }
    }
  }
}

// Shared memory of a block: the packed rows and the d1 rows of its band,
// and the tail's table
// (ops/cuda_edt.py::smem_bytes is the same formula).
size_t smem_bytes(int W, int R, int band) {
  const size_t rows = static_cast<size_t>(band) + 2 * R;
  const size_t words = (rows * ((W + 31) / 32 + 4) + 3) / 4 * 4;
  return sizeof(uint32_t) *
         (words + rows * 4 * ((W + 7) / 8) + static_cast<size_t>(R) * R + 2);
}

}  // namespace

// band: output rows a block, chosen by ops/cuda_edt.py (which also checks
// shapes and types) so that a block's shared memory fits; R in 0..64.
extern "C" int slam_edt_clamped(const void* occ, void* out, int B, int H,
                                int W, int R, int band, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (R < 0 || R > MAX_R || band < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // raised before the first launch: the default limit of 48 KB also
  // counts the kernel's static shared memory
  static size_t configured = 0;
  const size_t shmem = smem_bytes(W, R, band);
  if (shmem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        edt_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = shmem;
  }
  const uint8_t* in = static_cast<const uint8_t*>(occ);
  float* dst = static_cast<float*>(out);
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  const int in_mode = W % 16 == 0 && a % 16 == 0 ? 2
                      : W % 4 == 0 && a % 4 == 0 ? 1
                                                 : 0;
  const int vec_out =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const dim3 grid((H + band - 1) / band, B);
  edt_band_kernel<<<grid, THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, dst, H, W, R, band, in_mode, vec_out);
  return static_cast<int>(cudaGetLastError());
}
