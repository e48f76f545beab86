// Ragged GQA attention over a token-major bf16 page pool.
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/page_attention.py
// (_kernel, launched by paged_attention) for the bf16 pool. Query t of row b
// sits at position min(positions[b] + t, S - 1) and attends the row's cache
// tokens at positions <= that, reached through the row's page table; pages
// past the row's last live token are never read.
//
// What bounds it on an H100: one decode step reads every live K and V row
// once (summed over the batch) and does ~4*Dh operations per row per query
// head, a few FLOPs per byte: it is bound by the bytes of the live cache at
// 3.35 TB/s. The design therefore:
//   * runs one block per (row, KV head) and has every warp score the query
//     rows of that KV head together (up to 4 at a time: the G = 4 heads of
//     Llama-3-8B at decode), so each K/V row is loaded once per block, not
//     once per query head, and without the TPU's wide dot with a head mask
//     (an MXU trick that would multiply the work by Hkv here);
//   * splits the row's live tokens across the block's warps in 32-token
//     tiles (lane i scores token i with 16-byte loads of its K row), each
//     warp keeping its own online softmax in f32, and merges the warps'
//     (max, sum, accumulator) triples at the end: the flash-decoding split,
//     inside one block;
//   * stages each tile's probabilities and V offsets in shared memory so
//     the P.V loop is unrolled and its V loads (coalesced, Dh/32 dims a
//     lane) are all in flight at once;
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

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, DH]
    const __nv_bfloat16* __restrict__ k,  // [P, page, Hkv, DH]
    const __nv_bfloat16* __restrict__ v,  // [P, page, Hkv, DH]
    const int* __restrict__ tables,       // [B, Pmax]
    const int* __restrict__ positions,    // [B]
    __nv_bfloat16* __restrict__ out,      // [B, T, Hq, DH]
    int T, int Hq, int Hkv, int page, int Pmax, float scale) {
  constexpr int DPL = DH / 32;  // output dims per lane
  __shared__ __align__(16) float qs[kRowGroup][DH];
  __shared__ float ps[kWarps][kRowGroup][32];
  __shared__ unsigned long long offs[kWarps][32];
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
  const unsigned long long tok_stride = (unsigned long long)Hkv * DH;

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
      const unsigned long long off =
          ((unsigned long long)tbl[tok / page] * page + tok % page) * tok_stride +
          (unsigned long long)kvh * DH;
      const uint4* kp = reinterpret_cast<const uint4*>(k + off);
      float dot[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) dot[i] = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const uint4 raw = __ldg(kp + c);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          const float4 qa = *reinterpret_cast<const float4*>(&qs[i][c * 8]);
          const float4 qb = *reinterpret_cast<const float4*>(&qs[i][c * 8 + 4]);
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
      offs[warp][lane] = off;
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const bool valid = t0 + lane <= q_pos[i];
        const float s = valid ? dot[i] * scale : kNegInf;
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
        ps[warp][i][lane] = p;
      }
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const __nv_bfloat16* vp = v + offs[warp][j] + lane * DPL;
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = __bfloat162float(vp[e]);
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

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* positions, void* out, int B, int T, int Hq, int Hkv,
                   int page, int Pmax, float scale, cudaStream_t s) {
  dim3 grid(B, Hkv);
  paged_attention_kernel<DH><<<grid, kWarps * 32, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<const int*>(tables),
      reinterpret_cast<const int*>(positions), reinterpret_cast<__nv_bfloat16*>(out), T, Hq,
      Hkv, page, Pmax, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* tables, const void* positions,
    void* out, int B, int T, int Hq, int Hkv, int Dh, int page, int Pmax, float scale,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return (int)launch<64>(q, k, v, tables, positions, out, B, T, Hq, Hkv, page, Pmax, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, tables, positions, out, B, T, Hq, Hkv, page, Pmax, scale, s);
    case 256:
      return (int)launch<256>(q, k, v, tables, positions, out, B, T, Hq, Hkv, page, Pmax, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
