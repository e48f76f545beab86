// W8A8 decode matmul: y[M, F] = bf16(f32(sum_k xq[m, k] * q[k, f]) * sx[m] * s[f]).
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/int8_matmul.py
// (_kernel_w8a8, launched by _call_w8a8 / int8_w8a8_matmul). The activations
// arrive quantized per row (int8 xq [M, K_pad], zero past the logical K, f32
// row scales sx [M]); q is the int8 weight pack [K_pad, F_pad] row-major
// (F_pad a multiple of 512, K_pad of 128, padding zero); s is f32 [F].
//
// What bounds it on an H100: at decode M <= 128 rows (8 on the serving
// path), so the product does ~2*M integer operations per weight byte, far
// below the int8 tensor cores' ridge (~590 operations per byte at 1,979
// TOP/s). The bound is streaming K*F weight bytes once at 3.35 TB/s, the
// same bytes as the weight-only kernel. The design therefore:
//   * reads every weight byte exactly once, as 8-byte loads that a warp
//     turns into 256 contiguous bytes: one thread owns 8 adjacent columns
//     and loads 4 consecutive K rows of them, then transposes the 4 x 4
//     byte blocks with __byte_perm so that each register holds 4 K values
//     of one column, and sums with __dp4a against 4 K values of xq (staged
//     in shared memory, already K-contiguous);
//   * splits F into 512-column tiles and K into slices (split-K), so that
//     even M = 1 puts a few hundred blocks on the 132 SMs;
//   * sums in int32, which is exact (|sum| <= 127 * 127 * K < 2^31 for
//     K < 133,000), writes int32 partials and reduces them in a second small
//     pass that applies sx and s in the reference's order:
//     (f32(acc) * sx) * s, one bf16 rounding. Every partial sum is exact, so
//     the output is bitwise its plain version's, whatever the split.
// The int8 tensor cores (mma.sync s8.s8.s32) are left for a later PR: at
// M = 8 the dp4a rate is not the limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 8;                    // one 8-byte load of int8 a K row
constexpr int kColGroups = 64;                       // threads across F
constexpr int kTileF = kColGroups * kColsPerThread;  // 512 = F_BLK
constexpr int kKGroups = kThreads / kColGroups;      // 4 threads share a column group across K
constexpr int kKStep = 4 * kKGroups;                 // K rows one pass of the 4 groups covers
constexpr int kRows = 8;                             // activation rows per pass
constexpr int kMaxKChunk = 512;                      // K rows per split (xq slice in shared memory)
constexpr int kInFlight = 2;                         // passes whose loads are issued together

// Rows a, b, c, d hold bytes (columns) 0..3 of 4 consecutive K rows; out[j]
// gets column j's 4 K values, K row a in the low byte (dp4a's order).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           int* out) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  out[0] = (int)__byte_perm(ab_lo, cd_lo, 0x5410);   // a0 b0 c0 d0
  out[1] = (int)__byte_perm(ab_lo, cd_lo, 0x7632);   // a1 b1 c1 d1
  out[2] = (int)__byte_perm(ab_hi, cd_hi, 0x5410);   // a2 b2 c2 d2
  out[3] = (int)__byte_perm(ab_hi, cd_hi, 0x7632);   // a3 b3 c3 d3
}

__global__ void __launch_bounds__(kThreads) w8a8_partial(
    const int8_t* __restrict__ xq,  // [M, K_pad]
    int M, int K_pad,
    const int8_t* __restrict__ q,   // [K_pad, F_pad]
    int F_pad, int k_chunk,
    int* __restrict__ ws) {         // [splits, M, F_pad]
  __shared__ int xs[kRows][kMaxKChunk / 4];
  __shared__ int red[kRows][kTileF];
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kg = tid / kColGroups;
  const int tile0 = blockIdx.x * kTileF;
  const int col0 = tile0 + cg * kColsPerThread;
  const int split = blockIdx.y;
  const int k_begin = split * k_chunk;
  const int k_len = max(0, min(K_pad, k_begin + k_chunk) - k_begin);  // a multiple of kKStep

  for (int m0 = 0; m0 < M; m0 += kRows) {
    const int rows = min(kRows, M - m0);
    for (int i = tid; i < kRows * (kMaxKChunk / 4); i += kThreads) {
      const int r = i / (kMaxKChunk / 4);
      const int w = i % (kMaxKChunk / 4);
      int val = 0;
      if (r < rows && 4 * w < k_len) {
        val = *reinterpret_cast<const int*>(xq + (size_t)(m0 + r) * K_pad + k_begin + 4 * w);
      }
      xs[r][w] = val;
    }
    __syncthreads();

    int acc[kRows][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0;
    }
    const int8_t* qcol = q + (size_t)k_begin * F_pad + col0;
    // 4 K rows x 8 columns of this thread starting at K row kk (relative)
    auto load = [&](int kk, int2 (&raw)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        raw[u] = __ldg(reinterpret_cast<const int2*>(qcol + (size_t)(kk + u) * F_pad));
      }
    };
    auto accumulate = [&](const int2 (&raw)[4], int kk) {
      int col[kColsPerThread];
      transpose4(raw[0].x, raw[1].x, raw[2].x, raw[3].x, col);
      transpose4(raw[0].y, raw[1].y, raw[2].y, raw[3].y, col + 4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int xw = xs[r][kk / 4];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = __dp4a(col[j], xw, acc[r][j]);
      }
    };
    int kk = 4 * kg;
    for (; kk + (kInFlight - 1) * kKStep < k_len; kk += kInFlight * kKStep) {
      int2 raw[kInFlight][4];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) load(kk + u * kKStep, raw[u]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) accumulate(raw[u], kk + u * kKStep);
    }
    for (; kk < k_len; kk += kKStep) {
      int2 raw[4];
      load(kk, raw);
      accumulate(raw, kk);
    }

    // Sum the kKGroups partials of each column group, one group at a time.
    for (int g = 0; g < kKGroups; ++g) {
      if (kg == g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            int* cell = &red[r][cg * kColsPerThread + j];
            *cell = (g == 0 ? 0 : *cell) + acc[r][j];
          }
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < rows * kTileF; i += kThreads) {
      const int r = i / kTileF;
      const int c = i % kTileF;
      ws[((size_t)split * M + m0 + r) * F_pad + tile0 + c] = red[r][c];
    }
    __syncthreads();
  }
}

__global__ void w8a8_finish(
    const int* __restrict__ ws, int splits, int M, int F, int F_pad,
    const float* __restrict__ sx, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ y) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * F) return;
  const int m = (int)(idx / F);
  const int f = (int)(idx % F);
  int acc = 0;
  for (int sp = 0; sp < splits; ++sp) acc += ws[((size_t)sp * M + m) * F_pad + f];
  const float a = __int2float_rn(acc) * sx[m];
  y[idx] = __float2bfloat16(a * scale[f]);
}

}  // namespace

extern "C" int int8_w8a8_matmul_launch(
    const void* xq, const void* sx, int M, int K_pad, const void* q, int F_pad,
    const void* scale, int F, void* ws, int splits, int k_chunk, void* y, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (k_chunk > kMaxKChunk || k_chunk % kKStep != 0 || K_pad % kKStep != 0 ||
      F_pad % kTileF != 0 || splits < 1 || M < 1) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(F_pad / kTileF, splits);
  w8a8_partial<<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const int8_t*>(xq), M, K_pad, reinterpret_cast<const int8_t*>(q),
      F_pad, k_chunk, reinterpret_cast<int*>(ws));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)M * F;
  const int threads = 256;
  w8a8_finish<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      reinterpret_cast<const int*>(ws), splits, M, F, F_pad,
      reinterpret_cast<const float*>(sx), reinterpret_cast<const float*>(scale),
      reinterpret_cast<__nv_bfloat16*>(y));
  return (int)cudaGetLastError();
}
