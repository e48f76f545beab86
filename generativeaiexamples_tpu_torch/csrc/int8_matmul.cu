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
// 3.35 TB/s, which is ~15 bytes a clock for each SM. A multiply on the f32
// lanes spends 8 FMAs a byte at M = 8 on top of the widening, so the SIMT
// issue rate, not the memory, set the pace. The design therefore:
//   * multiplies on the tensor cores: mma.sync m16n8k16, bf16 x bf16 -> f32.
//     The weight tile is the 16-row operand (W^T: 16 output columns x 16 k)
//     and x^T the 8-column one, so the serving batch M = 8 fills the
//     instruction with no padding. int8 widens to bf16 exactly and x is
//     bf16, so every product is exact in f32 and the result differs from
//     the plain version only by summation order;
//   * streams the weights as 16-byte loads, each byte read once: lane
//     (g, t) of a warp (g = lane / 4, t = lane % 4) loads the 16 columns
//     [16 g, 16 g + 16) of the four k rows 4 t .. 4 t + 3 of a 16-row step,
//     so a warp reads 128 contiguous bytes of each row; kDepth = 2 steps
//     (64 bytes a thread each, 64 KB an SM with two blocks resident) are in
//     flight in registers before the first is used. On the H100 depth 2
//     beat 1, 3 and 4 by 3 to 9 % on one layer's projections, and 6 or 8
//     spill: past two steps the registers cost more than the bytes in
//     flight gain;
//   * needs no transpose through memory: the order of k inside one mma step
//     and the order of the 16 rows of the weight tile are free, as long as
//     x's fragment uses the same k order and the epilogue undoes the row
//     order. mma j of a step (j < 8) takes tile rows g and g + 8 from the
//     lane's own columns 2 j and 2 j + 1, and k slots (2 t, 2 t + 1, 2 t + 8,
//     2 t + 9) from the lane's own four rows; x's fragment is then the four
//     consecutive values x[g][4 t .. 4 t + 3], one 8-byte read of shared
//     memory a step, shared by the 8 mmas. x comes into shared memory in
//     chunks of 1024 k by cp.async, the next chunk in flight while this one
//     multiplies. (Reading x's fragments straight from device memory into
//     the register ring was tried and lost: 8-byte reads scattered over 8
//     rows, and the extra registers spilled; the lm_head took 1.7x as long
//     on the same H100.)
//   * widens a byte to bf16 with integer instructions: the byte (sign bit
//     flipped, so it reads v + 128) goes into the low mantissa of 2^23 with
//     one byte permute, one f32 subtraction of 2^23 + 128 leaves v exactly,
//     and a byte permute packs the high halves of two such floats (exact
//     bf16: |v| <= 128) into one register: 2.5 instructions a weight byte;
//   * gives a block a 128-column tile of F and 8 warps that interleave the
//     16-row steps of the block's K range, summed through shared memory in
//     warp order at the end (in-block split-K that costs no device memory),
//     and splits K across blocks only as far as the card needs to fill
//     (the wrapper's mma_plan): each split writes f32 partials, and the
//     last block of a column tile to finish, found by an atomic ticket,
//     sums them in split order, scales and writes bf16 (deterministic, no
//     float atomics, and no second launch on a host-bound decode step).
//     The tickets live in a small int32 buffer that the wrapper zeroes once
//     and keeps per stream; the summing block sets its ticket back to 0.
//     A projection with one split (the lm_head, whose F tiles alone fill
//     the card) scales and writes bf16 from its own sums: no partials;
//   * loops only over the logical K (x past K is zero in shared memory and
//     row reads are clamped to the pack's last row), and writes only the
//     logical F;
//   * M > 8 runs two groups of 8 rows against the same widened weight
//     fragments (M <= 16 in one pass), more rows in passes of 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// devices a process may launch on (the per-device attribute flags)
constexpr int kMaxDevices = 64;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileF = 128;                 // columns a block (and each of its warps)
constexpr int kStep = 16;                   // k rows one mma step
constexpr int kBlockStep = kWarps * kStep;  // k rows one round of the 8 warps
constexpr int kDepth = 2;                   // steps of weight loads in flight a thread
constexpr int kXChunk = 1024;               // k columns of x staged at a time, two chunks resident
constexpr int kXStride = kXChunk + 16;      // bf16 elements; 32 bytes past a multiple of 128
constexpr int kRoundsPerChunk = kXChunk / kBlockStep;
constexpr int kRedStride = kTileF + 4;      // f32 elements of one row of the reduce buffer

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte p of w (an int8 with its sign bit flipped: v + 128) as the float v.
__device__ __forceinline__ float widen(uint32_t w, int p) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + p)) - 8388736.f;  // 2^23 + 128
}

// bf16x2 (lo, hi) of two floats that are exact in bf16.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int MG>  // groups of 8 activation rows a pass
__global__ void __launch_bounds__(kThreads, MG == 1 ? 2 : 1) int8_matmul_mma(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    int M, int K,
    const int8_t* __restrict__ q,         // [K_pad, F_pad]
    int K_pad, int F_pad, int k_chunk, int splits,
    const float* __restrict__ scale,      // [F]
    int F,
    float* ws,                            // [splits, M, F_pad], unused when splits == 1
    int* tickets,                         // [passes of M, column tiles], zero between launches
    __nv_bfloat16* __restrict__ y) {      // [M, F]
  __shared__ int is_last;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][8 MG][kXStride]
  float* red = reinterpret_cast<float*>(smem);                 // [kWarps][8][kRedStride], after the loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int f0 = blockIdx.x * kTileF;
  const int split = blockIdx.y;
  const int k_begin = split * k_chunk;
  const int k_len = max(0, min(K, k_begin + k_chunk) - k_begin);
  // rounds of the 8 warps; a step past k_len multiplies by zeros of x
  const int rounds = (k_len + kBlockStep - 1) / kBlockStep;
  const int8_t* qcol = q + f0 + 16 * g;
  // 16-byte copies of x need whole groups of 8 inside K (then k_len % 8 == 0 too)
  const bool x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  // the lane's 4 rows x 16 columns of the warp's step of round r
  auto load = [&](uint4 (&raw)[4], int r) {
    const int row0 = k_begin + (r * kWarps + warp) * kStep + 4 * t4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = min(row0 + i, K_pad - 1);
      raw[i] = __ldg(reinterpret_cast<const uint4*>(qcol + (size_t)row * F_pad));
    }
  };

  // Chunk c of x (kXChunk columns of the split, rows m0 .. m0 + 8 MG) into
  // half c % 2 of xs, zero past M and past k_len: asynchronous 16-byte
  // copies where x allows them, else element by element.
  auto stage = [&](int c, int m0) {
    __nv_bfloat16* dst = xs + (c % 2) * (8 * MG * kXStride);
    const int c0 = c * kXChunk;
    const int width = min(kXChunk, rounds * kBlockStep - c0);
    if (x_vec) {
      for (int e = tid; e < 8 * MG * (width / 8); e += kThreads) {
        const int row = e / (width / 8), col = (e % (width / 8)) * 8;
        const bool in = m0 + row < M && c0 + col < k_len;
        const __nv_bfloat16* src = in ? x + (size_t)(m0 + row) * K + k_begin + c0 + col : x;
        cp_async16(dst + row * kXStride + col, src, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < 8 * MG * width; e += kThreads) {
        const int row = e / width, col = e % width;
        const bool in = m0 + row < M && c0 + col < k_len;
        dst[row * kXStride + col] =
            in ? x[(size_t)(m0 + row) * K + k_begin + c0 + col] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  for (int m0 = 0; m0 < M; m0 += 8 * MG) {
    float acc[MG][8][4];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[mg][j][0] = acc[mg][j][1] = acc[mg][j][2] = acc[mg][j][3] = 0.f;
    }
    stage(0, m0);
    uint4 raw[kDepth][4];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (u < rounds) load(raw[u], u);
    }

    for (int r0 = 0; r0 < rounds; r0 += kDepth) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int r = r0 + u;
        if (r >= rounds) break;
        if (r % kRoundsPerChunk == 0) {
          // Chunk c was issued a whole chunk ago (chunk 0: before the weight
          // prologue). Every warp is done with chunk c - 1, whose half the
          // next chunk's copies now overwrite while chunk c multiplies.
          const int c = r / kRoundsPerChunk;
          if (c > 0) __syncthreads();
          if ((c + 1) * kRoundsPerChunk < rounds) {
            stage(c + 1, m0);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
        }
        // x's fragments of this step: x[g][4 t4 .. 4 t4 + 3] of each row group
        const __nv_bfloat16* xc = xs + ((r / kRoundsPerChunk) % 2) * (8 * MG * kXStride) +
                                  (r % kRoundsPerChunk) * kBlockStep + warp * kStep + 4 * t4;
        uint2 xb[MG];
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
          xb[mg] = *reinterpret_cast<const uint2*>(xc + (mg * 8 + g) * kXStride);
        }
        uint32_t w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i][0] = raw[u][i].x ^ 0x80808080u;
          w[i][1] = raw[u][i].y ^ 0x80808080u;
          w[i][2] = raw[u][i].z ^ 0x80808080u;
          w[i][3] = raw[u][i].w ^ 0x80808080u;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // tile rows g, g + 8 = the lane's columns 2 j, 2 j + 1
          const int wi = j / 2, p = 2 * (j % 2);
          const uint32_t a0 = pack_bf16(widen(w[0][wi], p), widen(w[1][wi], p));
          const uint32_t a1 = pack_bf16(widen(w[0][wi], p + 1), widen(w[1][wi], p + 1));
          const uint32_t a2 = pack_bf16(widen(w[2][wi], p), widen(w[3][wi], p));
          const uint32_t a3 = pack_bf16(widen(w[2][wi], p + 1), widen(w[3][wi], p + 1));
#pragma unroll
          for (int mg = 0; mg < MG; ++mg) mma_bf16(acc[mg][j], a0, a1, a2, a3, xb[mg].x, xb[mg].y);
        }
        // refill the slot once its bytes are widened: kDepth - 1 steps stay in flight
        if (r + kDepth < rounds) load(raw[u], r + kDepth);
      }
    }

    // Sum the 8 warps' tiles in warp order. Lane (g, t4) holds, for mma j,
    // columns 16 g + 2 j (c0, c1) and 16 g + 2 j + 1 (c2, c3) of rows 2 t4
    // (c0, c2) and 2 t4 + 1 (c1, c3).
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      __syncthreads();  // every warp is done with xs (or with the last group's sums)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* cell = red + (warp * 8 + 2 * t4) * kRedStride + 16 * g + 2 * j;
        cell[0] = acc[mg][j][0];
        cell[kRedStride] = acc[mg][j][1];
        cell[1] = acc[mg][j][2];
        cell[kRedStride + 1] = acc[mg][j][3];
      }
      __syncthreads();
      for (int o = tid; o < 8 * kTileF; o += kThreads) {
        const int m = o / kTileF, f = o % kTileF;
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) sum += red[(wp * 8 + m) * kRedStride + f];
        const int row = m0 + mg * 8 + m, col = f0 + f;
        if (row >= M) continue;
        if (splits > 1) {
          ws[((size_t)split * M + row) * F_pad + col] = sum;
        } else if (col < F) {
          y[(size_t)row * F + col] = __float2bfloat16(sum * scale[col]);
        }
      }
    }
    if (splits > 1) {  // the last split of this tile to get here sums them all, in split order
      __threadfence();  // this block's partials are visible before its ticket
      __syncthreads();
      if (tid == 0) {
        int* ticket = tickets + (m0 / (8 * MG)) * gridDim.x + blockIdx.x;
        is_last = atomicAdd(ticket, 1) == splits - 1;
        if (is_last) *ticket = 0;  // every other split has drawn: ready for the next launch
      }
      __syncthreads();
      if (is_last) {
        __threadfence();
        for (int o = tid; o < 8 * MG * kTileF; o += kThreads) {
          const int row = m0 + o / kTileF, col = f0 + o % kTileF;
          if (row >= M || col >= F) continue;
          float sum = 0.f;
          for (int sp = 0; sp < splits; ++sp) {  // other blocks wrote these: read past L1
            sum += __ldcg(ws + ((size_t)sp * M + row) * F_pad + col);
          }
          y[(size_t)row * F + col] = __float2bfloat16(sum * scale[col]);
        }
      }
    }
    __syncthreads();  // the sums are read before the next pass writes its own
  }
}

template <int MG>
cudaError_t launch(const __nv_bfloat16* x, int M, int K, const int8_t* q, int K_pad, int F_pad,
                   int k_chunk, int splits, const float* scale, int F, float* ws, int* tickets,
                   __nv_bfloat16* y, cudaStream_t s) {
  constexpr int x_bytes = 2 * 8 * MG * kXStride * 2;
  constexpr int red_bytes = kWarps * 8 * kRedStride * 4;
  constexpr int bytes = x_bytes > red_bytes ? x_bytes : red_bytes;
  // the attribute is the current device's: set it once on each device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return dev_err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(int8_matmul_mma<MG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  int8_matmul_mma<MG><<<dim3(F_pad / kTileF, splits), kThreads, bytes, s>>>(
      x, M, K, q, K_pad, F_pad, k_chunk, splits, scale, F, ws, tickets, y);
  return cudaGetLastError();
}

}  // namespace

// ws: f32 [splits, M, F_pad] and tickets: int32 [ceil(M / 8 or 16), F_pad / 128],
// all zero; both null when splits == 1 (the block writes y itself).
extern "C" int int8_matmul_launch(
    const void* x, int M, int K, const void* q, int K_pad, int F_pad, const void* scale,
    int F, void* ws, void* tickets, int splits, int k_chunk, void* y, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || K > K_pad || F_pad % kTileF != 0 || splits < 1 ||
      k_chunk % kBlockStep != 0 || (long long)splits * k_chunk < K ||
      (splits > 1 && (ws == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(x);
  const int8_t* qp = reinterpret_cast<const int8_t*>(q);
  const float* sp = reinterpret_cast<const float*>(scale);
  float* wp = reinterpret_cast<float*>(ws);
  int* tp = reinterpret_cast<int*>(tickets);
  __nv_bfloat16* yp = reinterpret_cast<__nv_bfloat16*>(y);
  return (int)(M <= 8
      ? launch<1>(xp, M, K, qp, K_pad, F_pad, k_chunk, splits, sp, F, wp, tp, yp, s)
      : launch<2>(xp, M, K, qp, K_pad, F_pad, k_chunk, splits, sp, F, wp, tp, yp, s));
}
