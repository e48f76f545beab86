// Decode attention over the fixed KV layout's head-major int8 cache.
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/decode_attention.py
// (_kernel, launched by decode_attention). One query token per slot: query
// head h of slot b reads KV head h / G of the slot's own strip,
//   k, v   int8 [B, Hkv, S, DH]   (head-major: a (slot, head) strip is contiguous)
//   ks, vs f32  [B, Hkv, 1, S]    (one scale per (slot, head, row))
// and attends the rows s <= min(positions[b], S - 1). The scales fold in after
// the integer dots, as in the TPU kernel: a score is dot(q, k_int) * (ks * scale),
// and P.V sums (p * vs) * v_int in f32. The TPU kernel rounds p * vs to bf16
// before its P.V dot; this kernel keeps it in f32. A slot with no live row
// (l == 0) gives 0, as the TPU kernel's _finish guards.
//
// What bounds it on an H100: a decode step reads every live K and V row of
// every (slot, KV head) once, DH + 8 bytes each with its two scales, and does
// ~4*DH operations per row per query head: a few operations per byte, so the
// bytes of the live cache at 3.35 TB/s bound it. The design therefore:
//   * runs one block per (slot, KV head) and scores the G query heads of that
//     KV head together (up to 4 at a time: the G = 4 heads of Llama-3-8B), so
//     each K and V row is read once per block, not once per query head (the
//     TPU kernel's wide dot over all heads with a block-diagonal P is an MXU
//     trick that would multiply the work by Hkv here);
//   * splits the slot's live rows across the block's warps in 32-row tiles:
//     lane i scores row i of the tile with 16-byte loads of its K row, widened
//     to f32 in registers (int8 converts exactly); each warp keeps its own
//     online softmax in f32 and the warps' (max, sum, accumulator) triples
//     merge in shared memory at the end: the flash-decoding split, inside one
//     block;
//   * stages each tile's V-scaled probabilities in shared memory so the P.V
//     loop is unrolled and its V loads (DH/32 bytes a lane, coalesced across
//     the warp) are in flight together;
//   * never reads a row past the slot's position.
// A ragged batch is bound by its longest strip's walk (one block per (slot,
// KV head) owns it); splitting a strip across blocks, wgmma and TMA are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowGroup = 4;  // query heads a warp scores together
constexpr float kNegInf = -1e30f;

// dot[i] += sum_{e < 8} qs[i][d + e] * kf[e], for every query head of the group.
template <int DH>
__device__ __forceinline__ void fma8(const float (*qs)[DH], int d, const float* kf,
                                     float (&dot)[kRowGroup]) {
#pragma unroll
  for (int i = 0; i < kRowGroup; ++i) {
    const float4 qa = *reinterpret_cast<const float4*>(&qs[i][d]);
    const float4 qb = *reinterpret_cast<const float4*>(&qs[i][d + 4]);
    dot[i] = fmaf(qa.x, kf[0], dot[i]);
    dot[i] = fmaf(qa.y, kf[1], dot[i]);
    dot[i] = fmaf(qa.z, kf[2], dot[i]);
    dot[i] = fmaf(qa.w, kf[3], dot[i]);
    dot[i] = fmaf(qb.x, kf[4], dot[i]);
    dot[i] = fmaf(qb.y, kf[5], dot[i]);
    dot[i] = fmaf(qb.z, kf[6], dot[i]);
    dot[i] = fmaf(qb.w, kf[7], dot[i]);
  }
}

// Unscaled dot products of one int8 K row with the group's query heads.
template <int DH>
__device__ __forceinline__ void score_row(const int8_t* __restrict__ row,
                                          const float (*qs)[DH], float (&dot)[kRowGroup]) {
  const uint4* kp = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {  // 16 values a load
    const uint4 raw = __ldg(kp + c);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float kf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kf[e] = (float)(int8_t)((w[2 * h + e / 4] >> (8 * (e % 4))) & 0xff);
      }
      fma8<DH>(qs, c * 16 + h * 8, kf, dot);
    }
  }
}

// The DH/32 values [lane * DPL, lane * DPL + DPL) of one int8 V row, as floats.
template <int DH>
__device__ __forceinline__ void load_v(const int8_t* __restrict__ row, int lane,
                                       float (&vf)[DH / 32]) {
  constexpr int DPL = DH / 32;
  const int d0 = lane * DPL;
  uint32_t w[(DPL + 3) / 4];
  if constexpr (DPL == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(row + d0);
  } else if constexpr (DPL == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(row + d0);
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(row + d0);
    w[0] = t.x;
    w[1] = t.y;
  }
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    vf[e] = (float)(int8_t)((w[e / 4] >> (8 * (e % 4))) & 0xff);
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, DH]
    const int8_t* __restrict__ k,         // [B, Hkv, S, DH]
    const float* __restrict__ ks,         // [B, Hkv, 1, S]
    const int8_t* __restrict__ v,         // [B, Hkv, S, DH]
    const float* __restrict__ vs,         // [B, Hkv, 1, S]
    const int* __restrict__ positions,    // [B]
    __nv_bfloat16* __restrict__ out,      // [B, Hq, DH]
    int Hq, int Hkv, int S, float scale) {
  constexpr int DPL = DH / 32;  // output dims per lane
  __shared__ __align__(16) float qs[kRowGroup][DH];
  __shared__ float ps[kWarps][kRowGroup][32];
  __shared__ float red_m[kWarps][kRowGroup];
  __shared__ float red_l[kWarps][kRowGroup];
  __shared__ float red_acc[kWarps][kRowGroup][DH];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = Hq / Hkv;
  const int last = min(positions[b], S - 1);  // rows s <= last are live
  const size_t strip = (size_t)b * Hkv + kvh;
  const int8_t* kb = k + strip * S * DH;
  const int8_t* vb = v + strip * S * DH;
  const float* ksb = ks + strip * S;
  const float* vsb = vs + strip * S;

  for (int rg = 0; rg < G; rg += kRowGroup) {
    const int nrows = min(kRowGroup, G - rg);
    const size_t head0 = (size_t)b * Hq + kvh * G + rg;  // first query head of the group
    for (int e = threadIdx.x; e < kRowGroup * DH; e += kWarps * 32) {
      const int i = e / DH;
      qs[i][e % DH] = i < nrows ? __bfloat162float(q[(head0 + i) * DH + e % DH]) : 0.f;
    }
    __syncthreads();

    float m[kRowGroup], l[kRowGroup], acc[kRowGroup][DPL];
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
    }

    for (int t0 = warp * 32; t0 <= last; t0 += kWarps * 32) {
      // Lanes past the last live row load the last live row (finite, cached)
      // and weigh it 0.
      const bool valid = t0 + lane <= last;
      const int row = min(t0 + lane, last);
      float dot[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) dot[i] = 0.f;
      score_row<DH>(kb + (size_t)row * DH, qs, dot);
      const float k_fold = __ldg(ksb + row) * scale;
      const float v_fold = __ldg(vsb + row);
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const float s = valid ? dot[i] * k_fold : kNegInf;
        float tile_max = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
        }
        const float m_new = fmaxf(m[i], tile_max);
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[i] - m_new);
        float psum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
        ps[warp][i][lane] = p * v_fold;
      }
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        float vf[DPL];
        load_v<DH>(vb + (size_t)min(t0 + j, last) * DH, lane, vf);
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          const float pj = ps[warp][i][j];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pj, vf[e], acc[i][e]);
        }
      }
      __syncwarp();
    }

    // Merge the warps' partial softmax states.
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i) {
      if (lane == 0) {
        red_m[warp][i] = m[i];
        red_l[warp][i] = l[i];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) red_acc[warp][i][lane * DPL + e] = acc[i][e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nrows * DH; e += kWarps * 32) {
      const int i = e / DH;
      const int d = e % DH;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][i]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(red_m[w][i] - mx);
        lsum += red_l[w][i] * f;
        a += red_acc[w][i][d] * f;
      }
      out[(head0 + i) * DH + d] = __float2bfloat16(a / (lsum == 0.f ? 1.f : lsum));
    }
    __syncthreads();
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                   const void* positions, void* out, int B, int Hq, int Hkv, int S, float scale,
                   cudaStream_t s) {
  dim3 grid(B, Hkv);
  decode_attention_kernel<DH><<<grid, kWarps * 32, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const int8_t*>(k),
      reinterpret_cast<const float*>(ks), reinterpret_cast<const int8_t*>(v),
      reinterpret_cast<const float*>(vs), reinterpret_cast<const int*>(positions),
      reinterpret_cast<__nv_bfloat16*>(out), Hq, Hkv, S, scale);
  return cudaGetLastError();
}

}  // namespace

// Arguments in the order of the Python API: q, k_q, k_s, v_q, v_s, positions.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* ks,
                                       const void* v, const void* vs, const void* positions,
                                       void* out, int B, int Hq, int Hkv, int S, int Dh,
                                       float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 64:
      return (int)launch<64>(q, k, ks, v, vs, positions, out, B, Hq, Hkv, S, scale, s);
    case 128:
      return (int)launch<128>(q, k, ks, v, vs, positions, out, B, Hq, Hkv, S, scale, s);
    case 256:
      return (int)launch<256>(q, k, ks, v, vs, positions, out, B, Hq, Hkv, S, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
