// W8A8 decode matmul with its per-token quantizer inside:
//   xq, sx = quantize_rows(x);  y[M, F] = bf16((f32(sum_k xq[m, k] * q[k, f]) * sx[m]) * s[f]).
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/int8_matmul.py
// (_kernel_w8a8, launched by _call_w8a8 / int8_w8a8_matmul) together with
// the quantize_rows that the JAX wrapper runs ahead of it. x is bf16 or f32
// [M, K] (M <= 128), q the int8 weight pack [K_pad, F_pad] row-major (F_pad a
// multiple of 512, K_pad of 128, padding zero), s f32 [F].
//
// What bounds it on an H100: at decode M <= 128 rows (8 on the serving
// path), so the product does ~2*M integer operations per weight byte, far
// below the int8 tensor cores' ridge (~590 operations per byte at 1,979
// TOP/s). The bound is streaming K*F weight bytes once at 3.35 TB/s, the
// same bytes as the weight-only kernel (csrc/int8_matmul.cu), which also
// has to widen every byte to bf16; here int8 goes into the mma as it is.
// A decode step is host-bound, so the call is also one launch with no
// plain-torch work around it. The design:
//   * one launch a call: every block reads its rows of x over the whole
//     logical K with 16-byte loads (x is at most M x K x 4 bytes and stays in
//     L2 across the blocks; blocks start their walks at different places so
//     they do not queue on the same lines) and reduces each row's absmax,
//     while its first weight loads are in flight. Then each lane quantizes
//     its own x fragment inside the k loop, from L1, bitwise as
//     quantize_rows: s = max(absmax / 127, 1e-8) and
//     q = clamp(rint(x / s), -127, 127), in f32 with IEEE division
//     (__fdiv_rn, so --use_fast_math cannot change it; a multiply by the
//     reciprocal where that provably rounds the same) and
//     round-half-to-even (rintf, as torch.round). Quantizing x into shared
//     memory ahead of the loop, behind a barrier, was slower on the H100;
//   * multiplies on the int8 tensor cores: mma.sync m16n8k32, s8 x s8 ->
//     s32. The weight tile is the 16-row operand (W^T: 16 output columns x
//     32 k) and x^T the 8-column one, so M = 8 fills the instruction; M <= 16
//     runs in one pass (two mmas share each weight fragment), more rows in
//     passes of 16;
//   * streams the weights as 16-byte loads, each byte read once: lane
//     (g, t) of a warp (g = lane / 4, t = lane % 4) loads the 16 columns
//     [16 g, 16 g + 16) of the eight k rows 8 t .. 8 t + 7 of a 32-row step,
//     so a warp reads 128 contiguous bytes of each row. The order of k inside
//     one mma and of the 16 tile rows are free as long as x's fragment uses
//     the same order: the lane's k slots (4 t .. 4 t + 3, 4 t + 16 .. 4 t + 19)
//     are its own rows 8 t .. 8 t + 3 and 8 t + 4 .. 8 t + 7, and mma j takes
//     tile rows g, g + 8 from the lane's columns 2 j, 2 j + 1. Its 4 x 4 byte
//     blocks turn k-major in registers with __byte_perm (0.5 instructions a
//     byte), and x's fragment is x[g][8 t .. 8 t + 7]: one 16-byte load of
//     bf16 x a step, quantized to 8 bytes;
//   * int8_matmul's grid: a block owns a 128-column tile of F and 8 warps
//     that interleave the 32-row steps of its K range, summed in shared
//     memory; K is split across blocks only as far as the card needs to fill
//     one wave (the wrapper's w8a8_plan). Each split writes int32 partials
//     and the last block of a column tile to finish, found by an atomic
//     ticket, sums them, scales and writes bf16 (one launch, no float
//     atomics); one split writes y itself. Every sum is an exact int32
//     (|sum| <= 127 * 127 * K < 2^31 for K < 133,000), so the output is
//     bitwise its plain version's, whatever the split;
//   * loops only over the logical K: x's fragment past K (and past the
//     split) is zero, and weight-row reads are clamped to the pack.
// A second entry (xq and sx given) runs the quantizer as a launch of its
// own, writing xq [M, K_pad] and sx [M], and then the same product reading
// those: the two-launch variant that the wrapper takes for K at or above
// its threshold (ops/int8_matmul.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileF = 128;                 // columns a block (and each of its warps)
constexpr int kStep = 32;                   // k rows one mma step
constexpr int kBlockStep = kWarps * kStep;  // k rows one round of the 8 warps
constexpr int kRedStride = kTileF + 4;      // int32 elements of one row of the reduce buffer
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Rows a, b, c, d hold bytes (columns) 0..3 of 4 consecutive k rows; out[j]
// gets column j's 4 k values, k row a in the low byte.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* out) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  out[0] = __byte_perm(ab_lo, cd_lo, 0x5410);        // a0 b0 c0 d0
  out[1] = __byte_perm(ab_lo, cd_lo, 0x7632);        // a1 b1 c1 d1
  out[2] = __byte_perm(ab_hi, cd_hi, 0x5410);        // a2 b2 c2 d2
  out[3] = __byte_perm(ab_hi, cd_hi, 0x7632);        // a3 b3 c3 d3
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 8 consecutive elements of x as f32, from a 16-byte-aligned address.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// quantize_rows' scale of a row whose absmax is m
__device__ __forceinline__ float row_scale_of(float m) {
  return fmaxf(__fdiv_rn(m, 127.0f), 1e-8f);
}

// rint(v / s), IEEE division, without a division for most v: with
// rs = 1/s rounded, v * rs (no fused multiply-add) is within 2^-16 of v / s
// for |v / s| < 128 (two f32 roundings of 2^-24 each), so the two round to
// the same integer unless v * rs lies within 2^-14 of a half-integer; those
// few take __fdiv_rn.
__device__ __forceinline__ uint32_t quantize1(float v, float s, float rs) {
  float t = __fmul_rn(v, rs);
  if (fabsf(t - floorf(t) - 0.5f) < 0x1p-14f) t = __fdiv_rn(v, s);
  const float r = fminf(fmaxf(rintf(t), -127.0f), 127.0f);
  return (uint32_t)(int)r & 0xffu;
}

__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float s, float rs) {
  uint2 out;
  out.x = quantize1(v[0], s, rs) | quantize1(v[1], s, rs) << 8 | quantize1(v[2], s, rs) << 16 |
          quantize1(v[3], s, rs) << 24;
  out.y = quantize1(v[4], s, rs) | quantize1(v[5], s, rs) << 8 | quantize1(v[6], s, rs) << 16 |
          quantize1(v[7], s, rs) << 24;
  return out;
}

// Where block (bx, by) starts a walk of n items: every block of a launch
// reads the same rows of x, and blocks that start apart spread their reads
// over L2's slices instead of queueing on the same lines.
__device__ __forceinline__ int walk_start(int n) {
  return n > 0 ? (int)((blockIdx.x * 64u + blockIdx.y * 8u) % (unsigned)n) : 0;
}

// The largest |x| of each of the block's `rows` rows (at most R) over the
// whole K, into out[r] (all threads read it after the call).
template <typename T, int R>
__device__ __forceinline__ void row_absmax(const T* __restrict__ x, int rows, int K, bool x_vec,
                                           float (*partial)[R], float* out) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = 0.f;
  if (x_vec) {
    const int n = K / 8, start = walk_start(n);
    for (int i = tid; i < n; i += kThreads) {
      const int k8 = i + start < n ? i + start : i + start - n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          float v[8];
          load8(x + (size_t)r * K + 8 * k8, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) mx[r] = fmaxf(mx[r], fabsf(v[i]));
        }
      }
    }
  } else {
    for (int k = tid; k < K; k += kThreads) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) mx[r] = fmaxf(mx[r], fabsf(to_f32(x[(size_t)r * K + k])));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) partial[warp][r] = mx[r];
  }
  __syncthreads();
  if (tid < R) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, partial[w][tid]);
    out[tid] = m;
  }
  __syncthreads();
}

template <typename T, int MG, bool kPre>  // MG: groups of 8 rows a pass; kPre: x arrives quantized
__global__ void __launch_bounds__(kThreads, MG == 1 ? 2 : 1) w8a8_mma(
    const T* __restrict__ x,            // [M, K], unused when kPre
    const int8_t* __restrict__ xq_in,   // [M, K_pad], kPre only
    const float* __restrict__ sx_in,    // [M], kPre only
    int M, int K,
    const int8_t* __restrict__ q,       // [K_pad, F_pad]
    int K_pad, int F_pad, int k_chunk, int splits,
    const float* __restrict__ scale,    // [F]
    int F,
    int* ws,                            // [splits, M, F_pad], unused when splits == 1
    int* tickets,                       // [passes of M, column tiles], zero between launches
    __nv_bfloat16* __restrict__ y) {    // [M, F]
  constexpr int R = 8 * MG;
  __shared__ float partial[kWarps][R];
  __shared__ float row_s[R];
  __shared__ int is_last;
  __shared__ int red[kWarps * 8 * kRedStride];  // the 8 warps' sums of one row group

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int f0 = blockIdx.x * kTileF;
  const int split = blockIdx.y;
  const int k_begin = split * k_chunk;
  const int k_len = max(0, min(K, k_begin + k_chunk) - k_begin);
  const int rounds = (k_len + kBlockStep - 1) / kBlockStep;
  const int8_t* qcol = q + f0 + 16 * g;
  // 16-byte loads of x need whole groups of 8 inside K (then k_len % 8 == 0 too)
  const bool x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  // the lane's 8 rows x 16 columns of the warp's step of round r
  auto load = [&](uint4 (&raw)[8], int r) {
    const int row0 = k_begin + (r * kWarps + warp) * kStep + 8 * t4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = min(row0 + i, K_pad - 1);
      raw[i] = __ldg(reinterpret_cast<const uint4*>(qcol + (size_t)row * F_pad));
    }
  };

  for (int m0 = 0; m0 < M; m0 += R) {
    const int rows = min(R, M - m0);
    uint4 raw[8];
    if (rounds > 0) load(raw, 0);  // in flight while the row scales are found
    if (kPre) {
      if (tid < R) row_s[tid] = tid < rows ? sx_in[m0 + tid] : 1.f;
    } else {
      row_absmax<T, R>(x + (size_t)m0 * K, rows, K, x_vec, partial, row_s);
      if (tid < R) row_s[tid] = row_scale_of(row_s[tid]);
    }
    __syncthreads();
    // the scale of the lane's x rows g (and g + 8), and its reciprocal
    float sr[MG], rs[MG];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      sr[mg] = row_s[mg * 8 + g];
      rs[mg] = __frcp_rn(sr[mg]);
    }

    int acc[MG][8][4];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[mg][j][0] = acc[mg][j][1] = acc[mg][j][2] = acc[mg][j][3] = 0;
    }
    for (int r = 0; r < rounds; ++r) {
      // x's fragment of this step, x[g][8 t .. 8 t + 7] of each row group,
      // quantized here from x (in L1 since the absmax read it), zero past M
      // and past the split's K
      const int k = r * kBlockStep + warp * kStep + 8 * t4;
      uint2 xb[MG];
      float v[MG][8];
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
        const int row = m0 + mg * 8 + g;
        const bool in = row < M && k < k_len;
        if (kPre) {
          xb[mg] = in ? *reinterpret_cast<const uint2*>(xq_in + (size_t)row * K_pad + k_begin + k)
                      : make_uint2(0u, 0u);
        } else if (in && x_vec) {
          load8(x + (size_t)row * K + k_begin + k, v[mg]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[mg][i] = in && k + i < k_len ? to_f32(x[(size_t)row * K + k_begin + k + i]) : 0.f;
          }
        }
      }
      // columns 0..15 of the lane's rows 8 t .. 8 t + 3 (lo) and 8 t + 4 .. 8 t + 7 (hi)
      uint32_t lo[16], hi[16];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        transpose4(word(raw[0], w), word(raw[1], w), word(raw[2], w), word(raw[3], w), lo + 4 * w);
        transpose4(word(raw[4], w), word(raw[5], w), word(raw[6], w), word(raw[7], w), hi + 4 * w);
      }
      if (!kPre) {
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) xb[mg] = quantize8(v[mg], sr[mg], rs[mg]);
      }
      if (r + 1 < rounds) load(raw, r + 1);  // the next step's bytes fly while this one multiplies
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // tile rows g, g + 8 = the lane's columns 2 j, 2 j + 1
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
          mma_s8(acc[mg][j], lo[2 * j], lo[2 * j + 1], hi[2 * j], hi[2 * j + 1], xb[mg].x, xb[mg].y);
        }
      }
    }

    // Sum the 8 warps' tiles. Lane (g, t4) holds, for mma j, columns
    // 16 g + 2 j (c0, c1) and 16 g + 2 j + 1 (c2, c3) of rows 2 t4 (c0, c2)
    // and 2 t4 + 1 (c1, c3).
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      __syncthreads();  // every warp is done with the last group's sums
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int* cell = red + (warp * 8 + 2 * t4) * kRedStride + 16 * g + 2 * j;
        cell[0] = acc[mg][j][0];
        cell[kRedStride] = acc[mg][j][1];
        cell[1] = acc[mg][j][2];
        cell[kRedStride + 1] = acc[mg][j][3];
      }
      __syncthreads();
      for (int o = tid; o < 8 * kTileF; o += kThreads) {
        const int m = o / kTileF, f = o % kTileF;
        int sum = 0;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) sum += red[(wp * 8 + m) * kRedStride + f];
        const int row = m0 + mg * 8 + m, col = f0 + f;
        if (row >= M) continue;
        if (splits > 1) {
          ws[((size_t)split * M + row) * F_pad + col] = sum;
        } else if (col < F) {
          y[(size_t)row * F + col] = __float2bfloat16(
              __fmul_rn(__fmul_rn(__int2float_rn(sum), row_s[mg * 8 + m]), scale[col]));
        }
      }
    }
    if (splits > 1) {  // the last split of this tile to get here sums them all
      __threadfence();  // this block's partials are visible before its ticket
      __syncthreads();
      if (tid == 0) {
        int* ticket = tickets + (m0 / R) * gridDim.x + blockIdx.x;
        is_last = atomicAdd(ticket, 1) == splits - 1;
        if (is_last) *ticket = 0;  // every other split has drawn: ready for the next launch
      }
      __syncthreads();
      if (is_last) {
        __threadfence();
        for (int o = tid; o < R * kTileF; o += kThreads) {
          const int m = o / kTileF, row = m0 + m, col = f0 + o % kTileF;
          if (row >= M || col >= F) continue;
          int sum = 0;
          for (int sp = 0; sp < splits; ++sp) {  // other blocks wrote these: read past L1
            sum += __ldcg(ws + ((size_t)sp * M + row) * F_pad + col);
          }
          y[(size_t)row * F + col] = __float2bfloat16(
              __fmul_rn(__fmul_rn(__int2float_rn(sum), row_s[m]), scale[col]));
        }
      }
    }
    __syncthreads();  // the sums and row scales are read before the next pass writes its own
  }
}

// The two-launch variant's first launch: one block a row writes quantize_rows'
// int8 row into xq [M, K_pad] (zero past K) and its scale into sx [M].
template <typename T>
__global__ void __launch_bounds__(kThreads) w8a8_quantize(
    const T* __restrict__ x, int K, int K_pad, int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float partial[kWarps][1];
  __shared__ float amax;
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * K;
  const bool x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  row_absmax<T, 1>(xr, 1, K, x_vec, partial, &amax);
  const float s = row_scale_of(amax), rs = __frcp_rn(s);
  if (threadIdx.x == 0) sx[row] = s;
  for (int c = 8 * threadIdx.x; c < K_pad; c += 8 * kThreads) {
    float v[8];
    if (x_vec && c < K) {
      load8(xr + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c + i < K ? to_f32(xr[c + i]) : 0.f;
    }
    *reinterpret_cast<uint2*>(xq + (size_t)row * K_pad + c) = quantize8(v, s, rs);
  }
}

template <typename T, int MG, bool kPre>
cudaError_t launch_mma(const T* x, const int8_t* xq, const float* sx, int M, int K,
                       const int8_t* q, int K_pad, int F_pad, int k_chunk, int splits,
                       const float* scale, int F, int* ws, int* tickets, __nv_bfloat16* y,
                       cudaStream_t s) {
  w8a8_mma<T, MG, kPre><<<dim3(F_pad / kTileF, splits), kThreads, 0, s>>>(
      x, xq, sx, M, K, q, K_pad, F_pad, k_chunk, splits, scale, F, ws, tickets, y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const T* x, int M, int K, const int8_t* q, int K_pad, int F_pad,
                       const float* scale, int F, int* ws, int* tickets, int splits, int k_chunk,
                       int8_t* xq, float* sx, __nv_bfloat16* y, cudaStream_t s) {
  if (xq != nullptr) {
    w8a8_quantize<T><<<M, kThreads, 0, s>>>(x, K, K_pad, xq, sx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return M <= 8 ? launch_mma<T, 1, true>(x, xq, sx, M, K, q, K_pad, F_pad, k_chunk, splits,
                                           scale, F, ws, tickets, y, s)
                  : launch_mma<T, 2, true>(x, xq, sx, M, K, q, K_pad, F_pad, k_chunk, splits,
                                           scale, F, ws, tickets, y, s);
  }
  return M <= 8 ? launch_mma<T, 1, false>(x, nullptr, nullptr, M, K, q, K_pad, F_pad, k_chunk,
                                          splits, scale, F, ws, tickets, y, s)
                : launch_mma<T, 2, false>(x, nullptr, nullptr, M, K, q, K_pad, F_pad, k_chunk,
                                          splits, scale, F, ws, tickets, y, s);
}

}  // namespace

// x: bf16 (x_f32 == 0) or f32 [M, K]; ws: int32 [splits, M, F_pad] and
// tickets: int32 [ceil(M / 8 or 16), F_pad / 128], all zero; both null when
// splits == 1 (the block writes y itself). xq: int8 [M, K_pad] and sx: f32
// [M], both given for the two-launch variant, else both null.
extern "C" int int8_w8a8_matmul_launch(
    const void* x, int x_f32, int M, int K, const void* q, int K_pad, int F_pad,
    const void* scale, int F, void* ws, void* tickets, int splits, int k_chunk, void* xq,
    void* sx, void* y, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || K > K_pad || K_pad % 8 != 0 || F_pad % kTileF != 0 || splits < 1 ||
      k_chunk % kBlockStep != 0 || (long long)splits * k_chunk < K ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)) || ((xq == nullptr) != (sx == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* qp = reinterpret_cast<const int8_t*>(q);
  const float* sp = reinterpret_cast<const float*>(scale);
  int* wp = reinterpret_cast<int*>(ws);
  int* tp = reinterpret_cast<int*>(tickets);
  int8_t* xqp = reinterpret_cast<int8_t*>(xq);
  float* sxp = reinterpret_cast<float*>(sx);
  __nv_bfloat16* yp = reinterpret_cast<__nv_bfloat16*>(y);
  return (int)(x_f32
      ? launch_all(reinterpret_cast<const float*>(x), M, K, qp, K_pad, F_pad, sp, F, wp, tp,
                   splits, k_chunk, xqp, sxp, yp, s)
      : launch_all(reinterpret_cast<const __nv_bfloat16*>(x), M, K, qp, K_pad, F_pad, sp, F, wp,
                   tp, splits, k_chunk, xqp, sxp, yp, s));
}
