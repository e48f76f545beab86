// Ragged GQA attention over a token-major page pool: bf16, int8 or int4 rows.
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/page_attention.py
// (_kernel, launched by paged_attention) for all three pools. Query t of row b
// sits at position min(positions[b] + t, S - 1) and attends the row's cache
// tokens at positions <= that, reached through the row's page table; pages
// past the row's last live token are never read.
//
// Pools (the template parameter KIND):
//   * bf16: rows of DH bf16;
//   * int8: rows of DH int8 plus f32 scales ks/vs [P, page, Hkv];
//   * int4: rows of DH/2 bytes, byte j holding lane j in its low nibble and
//     lane j + DH/2 in its high nibble (sign-extended 4-bit values), with the
//     same scales.
// The scales fold in after the integer dots, as in the TPU kernel: a score is
// dot(q, k_int) * (ks * scale), and P.V sums (p * vs) * v_int. The TPU kernel
// rounds p * vs to bf16 before its P.V dot; this kernel keeps it in f32.
//
// What bounds it on an H100: one decode step reads every live K and V row
// once (summed over the batch) and does ~4*Dh operations per row per query
// head, a few operations per byte: it is bound by the bytes of the live cache
// at 3.35 TB/s. A bf16 row is 2*Dh bytes, an int8 row Dh + 8 (its two scales),
// an int4 row Dh/2 + 8. The design therefore:
//   * runs one block per (row, KV head) and has every warp score the query
//     rows of that KV head together (up to 4 at a time: the G = 4 heads of
//     Llama-3-8B at decode), so each K/V row is loaded once per block, not
//     once per query head, and without the TPU's wide dot with a head mask
//     (an MXU trick that would multiply the work by Hkv here);
//   * splits the row's live tokens across the block's warps in 32-token
//     tiles (lane i scores token i with 16-byte loads of its K row, widened
//     to f32 in registers: int8 and int4 values convert exactly), each warp
//     keeping its own online softmax in f32, and merges the warps'
//     (max, sum, accumulator) triples at the end: the flash-decoding split,
//     inside one block;
//   * stages each tile's probabilities (V scale folded in) and row indices in
//     shared memory so the P.V loop is unrolled and its V loads (coalesced,
//     Dh/32 dims a lane) are all in flight at once;
//   * reads the page table itself, so dead rows (position 0, table pointing
//     at scratch page 0) read one scratch row and return finite values.
// Splitting one row across several blocks is left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowGroup = 4;  // query rows a warp scores together
constexpr float kNegInf = -1e30f;

enum PoolKind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// Bytes of one (token, KV head) row of the pool.
template <int KIND, int DH>
__host__ __device__ constexpr int row_bytes() {
  return KIND == kBf16 ? 2 * DH : (KIND == kInt8 ? DH : DH / 2);
}

// Sign-extended 4-bit value of bits [bit, bit + 4) of w.
__device__ __forceinline__ float nibble(uint32_t w, int bit) {
  return (float)((int)(w << (28 - bit)) >> 28);
}

// dot[i] += sum_{e < 8} qs[i][d + e] * kf[e], for every query row of the group.
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

// Unscaled dot products of one K row with the group's query rows.
template <int KIND, int DH>
__device__ __forceinline__ void score_row(const uint8_t* __restrict__ row,
                                          const float (*qs)[DH], float (&dot)[kRowGroup]) {
  const uint4* kp = reinterpret_cast<const uint4*>(row);
  if constexpr (KIND == kBf16) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {  // 8 values a load
      const uint4 raw = __ldg(kp + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
      fma8<DH>(qs, c * 8, kf, dot);
    }
  } else if constexpr (KIND == kInt8) {
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
  } else {
    // 32 values a load: bytes [16c, 16c + 16) carry lanes 16c + j (low
    // nibbles) and DH/2 + 16c + j (high nibbles).
#pragma unroll
    for (int c = 0; c < DH / 32; ++c) {
      const uint4 raw = __ldg(kp + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lo[8], hi[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t word = w[2 * h + e / 4];
          lo[e] = nibble(word, 8 * (e % 4));
          hi[e] = nibble(word, 8 * (e % 4) + 4);
        }
        fma8<DH>(qs, c * 16 + h * 8, lo, dot);
        fma8<DH>(qs, DH / 2 + c * 16 + h * 8, hi, dot);
      }
    }
  }
}

// The DH/32 dims [lane * DPL, lane * DPL + DPL) of one V row, as floats.
template <int KIND, int DH>
__device__ __forceinline__ void load_v(const uint8_t* __restrict__ row, int lane,
                                       float (&vf)[DH / 32]) {
  constexpr int DPL = DH / 32;
  const int d0 = lane * DPL;
  if constexpr (KIND == kBf16) {
    const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(row) + d0;
#pragma unroll
    for (int e = 0; e < DPL; ++e) vf[e] = __bfloat162float(vp[e]);
  } else {
    // int8: DPL bytes at d0. int4: the same DPL bytes serve both halves of
    // the row: lanes below DH/2 take their low nibbles, the rest the high.
    const int b0 = KIND == kInt8 ? d0 : d0 % (DH / 2);
    uint32_t w[(DPL + 3) / 4];
    if constexpr (DPL == 2) {
      w[0] = *reinterpret_cast<const uint16_t*>(row + b0);
    } else if constexpr (DPL == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(row + b0);
    } else {
      const uint2 t = *reinterpret_cast<const uint2*>(row + b0);
      w[0] = t.x;
      w[1] = t.y;
    }
    const int shift = (KIND == kInt4 && d0 >= DH / 2) ? 4 : 0;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const uint32_t word = w[e / 4];
      if constexpr (KIND == kInt8) {
        vf[e] = (float)(int8_t)((word >> (8 * (e % 4))) & 0xff);
      } else {
        vf[e] = nibble(word, 8 * (e % 4) + shift);
      }
    }
  }
}

template <int KIND, int DH>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, DH]
    const uint8_t* __restrict__ k,        // [P, page, Hkv, row_bytes]
    const uint8_t* __restrict__ v,        // [P, page, Hkv, row_bytes]
    const float* __restrict__ ks,         // [P, page, Hkv] (int8 / int4 pools)
    const float* __restrict__ vs,         // [P, page, Hkv]
    const int* __restrict__ tables,       // [B, Pmax]
    const int* __restrict__ positions,    // [B]
    __nv_bfloat16* __restrict__ out,      // [B, T, Hq, DH]
    int T, int Hq, int Hkv, int page, int Pmax, float scale) {
  constexpr int DPL = DH / 32;  // output dims per lane
  constexpr int RB = row_bytes<KIND, DH>();
  __shared__ __align__(16) float qs[kRowGroup][DH];
  __shared__ float ps[kWarps][kRowGroup][32];
  __shared__ unsigned long long rows[kWarps][32];
  __shared__ float red_m[kWarps][kRowGroup];
  __shared__ float red_l[kWarps][kRowGroup];
  __shared__ float red_acc[kWarps][kRowGroup][DH];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = Hq / Hkv;
  const int R = T * G;  // query rows of this KV head
  const int S = Pmax * page;
  const int pos0 = positions[b];
  const int* tbl = tables + (size_t)b * Pmax;

  for (int rg = 0; rg < R; rg += kRowGroup) {
    const int nrows = min(kRowGroup, R - rg);
    int q_pos[kRowGroup];
    int q_last = 0;
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i) {
      q_pos[i] = i < nrows ? min(pos0 + (rg + i) / G, S - 1) : -1;
      q_last = max(q_last, q_pos[i]);
    }
    for (int e = threadIdx.x; e < kRowGroup * DH; e += kWarps * 32) {
      const int i = e / DH;
      const int d = e % DH;
      float val = 0.f;
      if (i < nrows) {
        const int r = rg + i;
        const int t = r / G;
        const int h = kvh * G + r % G;
        val = __bfloat162float(q[(((size_t)b * T + t) * Hq + h) * DH + d]);
      }
      qs[i][d] = val;
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

    for (int t0 = warp * 32; t0 <= q_last; t0 += kWarps * 32) {
      // Lanes past the last live token load the last live token's row
      // (finite, cached) and weigh it 0.
      const int tok = min(t0 + lane, q_last);
      // (token, KV head) row index: the row's bytes and its scales
      const unsigned long long row =
          ((unsigned long long)tbl[tok / page] * page + tok % page) * Hkv + kvh;
      float dot[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) dot[i] = 0.f;
      score_row<KIND, DH>(k + row * RB, qs, dot);
      float k_fold = scale, v_fold = 1.f;
      if constexpr (KIND != kBf16) {
        k_fold = __ldg(ks + row) * scale;
        v_fold = __ldg(vs + row);
      }
      rows[warp][lane] = row;
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const bool valid = t0 + lane <= q_pos[i];
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
        load_v<KIND, DH>(v + rows[warp][j] * RB, lane, vf);
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
      const int r = rg + i;
      const int t = r / G;
      const int h = kvh * G + r % G;
      out[(((size_t)b * T + t) * Hq + h) * DH + d] =
          __float2bfloat16(a / (lsum == 0.f ? 1.f : lsum));
    }
    __syncthreads();
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* tables;
  const void* positions;
  void* out;
  int B, T, Hq, Hkv, page, Pmax;
  float scale;
};

template <int KIND, int DH>
cudaError_t launch(const Args& a, cudaStream_t s) {
  dim3 grid(a.B, a.Hkv);
  paged_attention_kernel<KIND, DH><<<grid, kWarps * 32, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(a.q), reinterpret_cast<const uint8_t*>(a.k),
      reinterpret_cast<const uint8_t*>(a.v), reinterpret_cast<const float*>(a.ks),
      reinterpret_cast<const float*>(a.vs), reinterpret_cast<const int*>(a.tables),
      reinterpret_cast<const int*>(a.positions), reinterpret_cast<__nv_bfloat16*>(a.out),
      a.T, a.Hq, a.Hkv, a.page, a.Pmax, a.scale);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_dh(const Args& a, int Dh, cudaStream_t s) {
  switch (Dh) {
    case 64:
      return launch<KIND, 64>(a, s);
    case 128:
      return launch<KIND, 128>(a, s);
    case 256:
      return launch<KIND, 256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 bf16 pool, 1 int8 pool, 2 int4 pool (ks/vs may be null for bf16).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* tables, const void* positions, void* out, int B, int T, int Hq, int Hkv,
    int Dh, int page, int Pmax, int kind, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Args a{q, k, v, ks, vs, tables, positions, out, B, T, Hq, Hkv, page, Pmax, scale};
  if (kind != kBf16 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case kBf16:
      return (int)launch_dh<kBf16>(a, Dh, s);
    case kInt8:
      return (int)launch_dh<kInt8>(a, Dh, s);
    case kInt4:
      return (int)launch_dh<kInt4>(a, Dh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
