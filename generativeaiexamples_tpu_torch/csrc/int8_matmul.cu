// W8A16 weight-streaming matmul for decode: y[M, F] = (x[M, K] @ bf16(q[K, F])) * scale[F].
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/int8_matmul.py
// (_kernel, launched by _call / int8_matmul). Same packed layout: q is int8
// [K_pad, F_pad] row-major (F_pad a multiple of 512, K_pad of 128, padding
// zero), scale is f32 [1, F] over the logical F.
//
// What bounds it on an H100: at decode M <= 128 rows (8 on the serving
// path), so the product does ~2*M operations per weight byte, far below the
// ~295 FLOP/byte ridge. The bound is streaming K*F int8 bytes once at
// 3.35 TB/s. The design therefore:
//   * reads every weight byte exactly once, as 8-byte loads that a warp
//     turns into 256 contiguous bytes, and converts int8 -> float in
//     registers (no bf16 copy of the weight ever reaches device memory);
//   * splits F into 512-column tiles and K into slices (split-K), so that
//     even M = 1 puts a few hundred blocks on the 132 SMs;
//   * loops only over the logical K, so the pack's zero K-padding and the
//     activation's missing columns never contribute;
//   * sums in f32 and applies the per-column scale once, after the sum, in
//     a second small pass that also reduces the split-K partials in a fixed
//     order (deterministic, no atomics) and writes only the logical F.
// Products of a bf16 activation and an int8 weight are exact in f32, so the
// result differs from the TPU kernel only by f32 summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 8;                      // one 8-byte load of int8
constexpr int kColGroups = 64;                         // threads across F
constexpr int kTileF = kColGroups * kColsPerThread;    // 512 = F_BLK
constexpr int kKGroups = kThreads / kColGroups;        // 4 threads share a column group across K
constexpr int kRows = 8;                               // activation rows per pass
constexpr int kMaxKChunk = 512;                        // K rows per split (x slice in shared memory)

__global__ void __launch_bounds__(kThreads) int8_matmul_partial(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    int M, int K,
    const int8_t* __restrict__ q,         // [K_pad, F_pad]
    int F_pad, int k_chunk,
    float* __restrict__ ws) {             // [splits, M, F_pad]
  __shared__ float xs[kRows][kMaxKChunk];
  __shared__ float red[kRows][kTileF];
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kg = tid / kColGroups;
  const int tile0 = blockIdx.x * kTileF;
  const int col0 = tile0 + cg * kColsPerThread;
  const int split = blockIdx.y;
  const int k_begin = split * k_chunk;
  const int k_len = max(0, min(K, k_begin + k_chunk) - k_begin);

  for (int m0 = 0; m0 < M; m0 += kRows) {
    const int rows = min(kRows, M - m0);
    for (int i = tid; i < kRows * kMaxKChunk; i += kThreads) {
      const int r = i / kMaxKChunk;
      const int kk = i % kMaxKChunk;
      float val = 0.f;
      if (r < rows && kk < k_len) {
        val = __bfloat162float(x[(size_t)(m0 + r) * K + k_begin + kk]);
      }
      xs[r][kk] = val;
    }
    __syncthreads();

    float acc[kRows][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;
    }
    const int8_t* qcol = q + (size_t)k_begin * F_pad + col0;
    auto accumulate = [&](const int2 raw, const int kk) {
      float w[kColsPerThread];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = (float)(int8_t)((raw.x >> (8 * j)) & 0xff);
        w[4 + j] = (float)(int8_t)((raw.y >> (8 * j)) & 0xff);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
      }
    };
    // kInFlight weight loads issued before any of them is used, so each
    // thread keeps 64 bytes in flight (the bound is memory latency x rate).
    constexpr int kInFlight = 8;
    int kk = kg;
    for (; kk + (kInFlight - 1) * kKGroups < k_len; kk += kInFlight * kKGroups) {
      int2 raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        raw[u] = __ldg(reinterpret_cast<const int2*>(qcol + (size_t)(kk + u * kKGroups) * F_pad));
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) accumulate(raw[u], kk + u * kKGroups);
    }
    for (; kk < k_len; kk += kKGroups) {
      accumulate(__ldg(reinterpret_cast<const int2*>(qcol + (size_t)kk * F_pad)), kk);
    }

    // Sum the kKGroups partials of each column group, one group at a time.
    for (int g = 0; g < kKGroups; ++g) {
      if (kg == g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            float* cell = &red[r][cg * kColsPerThread + j];
            *cell = (g == 0 ? 0.f : *cell) + acc[r][j];
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

__global__ void int8_matmul_finish(
    const float* __restrict__ ws, int splits, int M, int F, int F_pad,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * F) return;
  const int m = (int)(idx / F);
  const int f = (int)(idx % F);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[((size_t)sp * M + m) * F_pad + f];
  y[idx] = __float2bfloat16(s * scale[f]);
}

}  // namespace

extern "C" int int8_matmul_launch(
    const void* x, int M, int K, const void* q, int F_pad, const void* scale,
    int F, void* ws, int splits, int k_chunk, void* y, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (k_chunk > kMaxKChunk || F_pad % kTileF != 0 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(F_pad / kTileF, splits);
  int8_matmul_partial<<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), M, K,
      reinterpret_cast<const int8_t*>(q), F_pad, k_chunk,
      reinterpret_cast<float*>(ws));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)M * F;
  const int threads = 256;
  int8_matmul_finish<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      reinterpret_cast<const float*>(ws), splits, M, F, F_pad,
      reinterpret_cast<const float*>(scale), reinterpret_cast<__nv_bfloat16*>(y));
  return (int)cudaGetLastError();
}
