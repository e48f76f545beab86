// Causal GQA flash attention for monolithic prefill.
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/flash_attention.py
// (_kernel, launched by flash_attention_causal): out[b, t, h] = softmax over
// keys s <= t of (q[b, t, h] . k[b, s, h // group]) / sqrt(D), times v. The
// T x T score matrix never reaches device memory.
//
// What bounds it on an H100: at T = 512 the work is ~4 * T^2 / 2 * D FLOPs per
// (batch, head) on 2 * T * D * 2 bytes of K/V, well above the ridge, so it is
// bound by operations. This first version does them in f32 on the CUDA cores
// (the TPU kernel also upcasts q, k, v to f32), not on the tensor cores; an
// mma/wgmma version is later work. Its design:
//   * one block per (q tile of 64 rows, q head, batch row); the block maps
//     q head h to KV head h // group, so K/V are never repeated in memory;
//   * the block loops over 32-token K/V tiles only up to the causal diagonal
//     (tiles wholly above it are skipped), staging Q, K, V and the tile's
//     probabilities in shared memory as f32;
//   * each thread owns a 4 x 2 block of scores and a 4 x (D/16) block of the
//     output, so every shared-memory read feeds several FMAs;
//   * the softmax is online, with f32 running max and sum per row reduced
//     across the 16 lanes that share a row, and a row whose sum stays 0
//     divides by 1 (the TPU kernel's l == 0 guard);
//   * rows and keys past T (a T that is not a tile multiple) are masked, and
//     only rows < T are written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, T, Hkv, D]
    __nv_bfloat16* __restrict__ out,      // [B, T, Hq, D]
    int T, int Hq, int Hkv, float scale) {
  constexpr int DPT = D / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr + 16 * i
  const int tc = tid % 16;  // score columns tc + 16 * j, output dims tc + 16 * d

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int tq = q0 + r;
    Qs[r * (D + 1) + d] =
        tq < T ? __bfloat162float(q[(((size_t)b * T + tq) * Hq + h) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  const int k_last = min(q0 + kBQ - 1, T - 1);
  for (int k0 = 0; k0 <= k_last; k0 += kBK) {
    __syncthreads();  // Q staged; previous tile's K, V, P consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D;
      const int d = i % D;
      const int tk = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (tk < T) {
        const size_t src = (((size_t)b * T + tk) * Hkv + kvh) * D + d;
        kv = __bfloat162float(k[src]);
        vv = __bfloat162float(v[src]);
      }
      Ks[c * (D + 1) + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
      const int q_pos = q0 + row;
      bool valid[2];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k_pos = k0 + tc + 16 * j;
        valid[j] = k_pos <= q_pos && k_pos < T;
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[row * (kBK + 1) + tc + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        const float vv = Vs[c * D + tc + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][d] = fmaf(pv[i], vv, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tq = q0 + tr + 16 * i;
    if (tq >= T) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    __nv_bfloat16* orow = out + (((size_t)b * T + tq) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[tc + 16 * d] = __float2bfloat16(acc[i][d] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int T,
                   int Hq, int Hkv, float scale, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<D><<<grid, kThreads, bytes, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(out), T, Hq,
      Hkv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int T, int Hq, int Hkv, int D, float scale,
                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, out, B, T, Hq, Hkv, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, out, B, T, Hq, Hkv, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
