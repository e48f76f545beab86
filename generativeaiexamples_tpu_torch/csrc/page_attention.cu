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
// an int4 row Dh/2 + 8. Reaching that rate takes many SMs with many bytes in
// flight each, while one decode batch holds only B x Hkv (row, KV head)
// pairs (64 at B = 8) and its longest row may be thousands of tokens. The
// design therefore:
//   * splits each row's tokens across blocks (flash-decoding): the grid is
//     (KV head x query-row group, row, split), a split being split_tokens
//     tokens (whole pages; the wrapper's SPLIT_TOKENS), and the number of
//     splits follows from the table's shape alone. A block whose split
//     starts past its rows' last query position returns at once;
//   * has each block keep the G query rows of its KV head together (up to 4
//     at a time: the G = 4 heads of Llama-3-8B at decode), so each K/V row is
//     read once per block, not once per query head;
//   * stages its split 64 tokens at a time, K and V rows (and the int8 /
//     int4 scales) gathered through the page table (one table read a thread a
//     tile) with 16-byte cp.async copies into a two-stage ring, so one tile's
//     loads overlap the previous tile's arithmetic; rows are padded by 16
//     bytes in shared memory, which keeps the reads of neighbouring lanes
//     free of bank conflicts; tokens past the split's end are zero-filled and
//     weigh 0;
//   * scores from shared memory on the CUDA cores: each thread holds 16 dims
//     of the block's query rows in registers for the whole split and scores
//     several tokens with them (K widened to f32 in registers: int8 and int4
//     values convert exactly), the parts' partial dots summed through shared
//     memory; it runs the online softmax in f32 with exp2 (one warp per query
//     row), and sums P.V with each thread owning 4 output dims over a slice of
//     the tile's tokens;
//   * writes its rows' (max, sum, accumulator) to a workspace, which a second
//     kernel, launched from the same entry point, merges across splits with
//     the log-sum-exp rule, applying the l == 0 guard; a query-row group
//     whose last position lies in the first split writes its output
//     directly and the merge skips it (every row of the smoke's serving
//     traffic), and the merge is not launched at all when the table holds
//     one split;
//   * reads the page table itself, so dead rows (position 0, table pointing
//     at scratch page 0) read one scratch row and return finite values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// devices a process may launch on (the per-device attribute flags)
constexpr int kMaxDevices = 64;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // query rows a block (one softmax warp each)
static_assert(kThreads / 32 == kRows, "one warp a query row in the softmax");
constexpr int kTile = 64;  // tokens a staged tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

enum PoolKind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// Bytes of one (token, KV head) row of the pool.
template <int KIND, int DH>
__host__ __device__ constexpr int row_bytes() {
  return KIND == kBf16 ? 2 * DH : (KIND == kInt8 ? DH : DH / 2);
}

// Shared-memory layout of one block (byte offsets) and its work split.
template <int KIND, int DH>
struct Smem {
  static constexpr int RB = row_bytes<KIND, DH>();
  static constexpr int LDB = RB + 16;            // padded row stride
  static constexpr int CPR = RB / 16;            // 16-byte chunks a row
  static constexpr int NP = DH / 16;             // scoring parts of a row, 16 dims each
  static constexpr int TG = kThreads / NP;       // token stride of a scoring thread
  static constexpr int TPT = kTile / TG;         // tokens a scoring thread scores a tile
  static constexpr int SD = NP * kRows + 1;      // padded stride of a token's partial dots
  static constexpr int DQ = DH / 4;              // dim quads of the P.V pass
  static constexpr int TS = kThreads / DQ;       // token slices of the P.V pass
  static constexpr int kv = 0;                   // [kStages][2][kTile][LDB]
  static constexpr int sc = kv + kStages * 2 * kTile * LDB;  // [kStages][2][kTile] f32
  static constexpr int qs = sc + kStages * 2 * kTile * 4;    // [kRows][DH] f32
  static constexpr int dot = qs + kRows * DH * 4;            // [kTile][SD] f32
  static constexpr int ps = dot + ((kTile * SD * 4 + 15) / 16) * 16;  // [kTile][kRows] f32
  static constexpr int alpha = ps + kTile * kRows * 4;       // [kRows] f32
  static constexpr int ml = alpha + kRows * 4;               // [2][kRows] f32
  static constexpr int bytes = ml + 2 * kRows * 4;
  static_assert(kThreads == 2 * kTile, "two threads stage each token's rows");
  static_assert(kTile % TG == 0 && CPR % 2 == 0, "work split");
  // after the tile loop the ring holds the P.V slices' partial sums
  static_assert(TS * kRows * DH * 4 <= kStages * 2 * kTile * LDB, "reduce buffer");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sign-extended 4-bit value of bits [bit, bit + 4) of w.
__device__ __forceinline__ float nibble(uint32_t w, int bit) {
  return (float)((int)(w << (28 - bit)) >> 28);
}

__device__ __forceinline__ void bf16x8(uint4 raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

// The 16 dims of scoring part p. bf16 and int4 take 8 dims from each half of
// the row (for int4 those are the low and high nibbles of bytes [8p, 8p + 8);
// for bf16 two 16-byte chunks, so that 8 neighbouring parts read 128
// neighbouring bytes); int8 takes the 16 bytes [16p, 16p + 16).
template <int KIND, int DH>
__device__ __forceinline__ int score_dim(int p, int e) {
  return KIND == kInt8 ? 16 * p + e : (e < 8 ? 8 * p + e : DH / 2 + 8 * p + e - 8);
}

// Part p of one staged K row, widened to f32 (int8 and int4 values exactly).
template <int KIND, int DH>
__device__ __forceinline__ void load_kpart(const uint8_t* row, int p, float (&kf)[16]) {
  if constexpr (KIND == kBf16) {
    bf16x8(*reinterpret_cast<const uint4*>(row + 16 * p), kf);
    bf16x8(*reinterpret_cast<const uint4*>(row + DH + 16 * p), kf + 8);
  } else if constexpr (KIND == kInt8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + 16 * p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) kf[e] = (float)(int8_t)((w[e / 4] >> (8 * (e % 4))) & 0xff);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + 8 * p);
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kf[e] = nibble(w[e / 4], 8 * (e % 4));
      kf[8 + e] = nibble(w[e / 4], 8 * (e % 4) + 4);
    }
  }
}

// The 4 output dims of P.V quad dq: (4 dq .. 4 dq + 3), or for the int4
// pool's split halves (2 dq, 2 dq + 1, DH/2 + 2 dq, DH/2 + 2 dq + 1), which
// share bytes 2 dq and 2 dq + 1 of a row.
template <int KIND, int DH>
__device__ __forceinline__ int pv_dim(int dq, int e) {
  return KIND == kInt4 ? (e < 2 ? 2 * dq + e : DH / 2 + 2 * dq + e - 2) : 4 * dq + e;
}

template <int KIND>
__device__ __forceinline__ void load_vquad(const uint8_t* row, int dq, float (&vf)[4]) {
  if constexpr (KIND == kBf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + 8 * dq);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    vf[0] = a.x, vf[1] = a.y, vf[2] = b.x, vf[3] = b.y;
  } else if constexpr (KIND == kInt8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * dq);
#pragma unroll
    for (int e = 0; e < 4; ++e) vf[e] = (float)(int8_t)((w >> (8 * e)) & 0xff);
  } else {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + 2 * dq);
    vf[0] = nibble(w, 0), vf[1] = nibble(w, 8), vf[2] = nibble(w, 4), vf[3] = nibble(w, 12);
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
  void* ws;
  int B, T, Hq, Hkv, page, Pmax, split_tokens, nsplit;
  float scale_log2;
};

// Which query rows a block serves, and how far they reach.
struct RowGroup {
  int b, kvh, r0, nrows, G, R, S, pos0, q_last;

  __device__ RowGroup(const Args& a, int y, int bz) {
    G = a.Hq / a.Hkv;
    R = a.T * G;  // query rows of one KV head, r = t * G + g
    const int ngroups = (R + kRows - 1) / kRows;
    b = bz;
    kvh = y / ngroups;
    r0 = (y % ngroups) * kRows;
    nrows = min(kRows, R - r0);
    S = a.Pmax * a.page;
    pos0 = reinterpret_cast<const int*>(a.positions)[b];
    q_last = min(pos0 + (r0 + nrows - 1) / G, S - 1);
  }
  __device__ int q_pos(int i) const { return i < nrows ? min(pos0 + (r0 + i) / G, S - 1) : -1; }
  // element offset of row i's output vector in out [B, T, Hq, DH]
  __device__ size_t out_off(const Args& a, int i, int dh) const {
    const int r = r0 + i;
    return (((size_t)b * a.T + r / G) * a.Hq + kvh * G + r % G) * dh;
  }
  // index of row i's state for split s in the workspace
  __device__ size_t state(const Args& a, int i, int s) const {
    return (((size_t)b * a.Hkv + kvh) * a.nsplit + s) * R + r0 + i;
  }
};

template <int KIND, int DH>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  using L = Smem<KIND, DH>;
  constexpr int RB = L::RB, LDB = L::LDB, CPR = L::CPR, NP = L::NP, TG = L::TG;
  constexpr int TPT = L::TPT, SD = L::SD, DQ = L::DQ, TS = L::TS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem + L::kv;
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* qs = reinterpret_cast<float*>(smem + L::qs);
  float* sdot = reinterpret_cast<float*>(smem + L::dot);
  float* ps = reinterpret_cast<float*>(smem + L::ps);
  float* salpha = reinterpret_cast<float*>(smem + L::alpha);
  float* sml = reinterpret_cast<float*>(smem + L::ml);

  const RowGroup g(a, blockIdx.x, blockIdx.y);
  const int split = blockIdx.z;
  const int c0 = split * a.split_tokens;
  if (c0 > g.q_last) return;  // the split starts past every row's last position
  const int c1 = min(c0 + a.split_tokens, g.q_last + 1);
  const bool direct = g.q_last < a.split_tokens;  // the only split: no merge
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int* tbl = reinterpret_cast<const int*>(a.tables) + (size_t)g.b * a.Pmax;

  // Two threads stage each token of a tile: half the chunks of its K and V
  // rows each, and one of its two scales; one page-table read a thread.
  auto issue = [&](int t0, int stage) {
    const int tok = tid % kTile, half = tid / kTile;
    const bool live = t0 + tok < c1;
    const int t = live ? t0 + tok : c0;
    const long long row = ((long long)__ldg(tbl + t / a.page) * a.page + t % a.page) * a.Hkv + g.kvh;
    uint8_t* kd = ring + ((stage * 2 + 0) * kTile + tok) * LDB;
    uint8_t* vd = ring + ((stage * 2 + 1) * kTile + tok) * LDB;
    const uint8_t* ksrc = reinterpret_cast<const uint8_t*>(a.k) + row * RB;
    const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(a.v) + row * RB;
#pragma unroll
    for (int u = 0; u < CPR / 2; ++u) {
      const int c = half * (CPR / 2) + u;
      cp_async16(kd + c * 16, ksrc + c * 16, live ? 16 : 0);
      cp_async16(vd + c * 16, vsrc + c * 16, live ? 16 : 0);
    }
    if constexpr (KIND != kBf16) {
      const float* src = reinterpret_cast<const float*>(half == 0 ? a.ks : a.vs);
      cp_async4(sc + (stage * 2 + half) * kTile + tok, src + row, live ? 4 : 0);
    }
  };

  const int ntiles = (c1 - c0 + kTile - 1) / kTile;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {  // one group a tile, empty past the end
    if (it < ntiles) issue(c0 + it * kTile, it);
    cp_async_commit();
  }
  for (int e = tid; e < kRows * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    qs[e] = i < g.nrows
                ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[g.out_off(a, i, DH) + d])
                : 0.f;
  }
  __syncthreads();
  // scoring: part sp (16 dims) of tokens tg + TG j, the query rows' dims of
  // that part held in registers for the whole split
  const int sp = tid % NP, tg = tid / NP;
  float qr[kRows][16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[i][e] = qs[i * DH + score_dim<KIND, DH>(sp, e)];
  }

  // softmax state of row `warp` (every lane holds it)
  const int my_pos = g.q_pos(warp);
  float m = -INFINITY, l = 0.f;
  // P.V: dim quad dq over token slice ts
  const int dq = tid % DQ, ts = tid / DQ;
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = c0 + it * kTile;
    const int stage = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` visible; every thread is done with tile it - 1
    if (it + kStages - 1 < ntiles) issue(t0 + (kStages - 1) * kTile, (it + kStages - 1) % kStages);
    cp_async_commit();

    const uint8_t* ktile = ring + (stage * 2 + 0) * kTile * LDB;
    const uint8_t* vtile = ring + (stage * 2 + 1) * kTile * LDB;
#pragma unroll
    for (int j = 0; j < TPT; ++j) {  // partial scores, one part of a token at a time
      const int tok = tg + TG * j;
      float kf[16];
      load_kpart<KIND, DH>(ktile + tok * LDB, sp, kf);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) d = fmaf(qr[i][e], kf[e], d);
        sdot[tok * SD + sp * kRows + i] = d;
      }
    }
    __syncthreads();

    {  // online softmax of row `warp` over the tile's tokens lane, lane + 32
      float s[2];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tok = u * 32 + lane;
        const int pos = t0 + tok;
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) dot += sdot[tok * SD + p * kRows + warp];
        float fold = a.scale_log2;
        if constexpr (KIND != kBf16) fold *= sc[(stage * 2 + 0) * kTile + tok];
        s[u] = pos <= my_pos && pos < c1 ? dot * fold : -INFINITY;
        tmax = fmaxf(tmax, s[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m, tmax);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m - base);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tok = u * 32 + lane;
        const float p = exp2f(s[u] - base);
        psum += p;
        float vfold = 1.f;
        if constexpr (KIND != kBf16) vfold = sc[(stage * 2 + 1) * kTile + tok];
        ps[tok * kRows + warp] = p * vfold;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l = l * alpha + psum;
      m = m_new;
      if (lane == 0) salpha[warp] = alpha;
    }
    __syncthreads();

    {  // P.V over the tile's live tokens
      const int ntok = min(kTile, c1 - t0);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float al = salpha[i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= al;
      }
#pragma unroll 4
      for (int tok = ts; tok < ntok; tok += TS) {
        const float4 p = *reinterpret_cast<const float4*>(ps + tok * kRows);
        const float pr[kRows] = {p.x, p.y, p.z, p.w};
        float vf[4];
        load_vquad<KIND>(vtile + tok * LDB, dq, vf);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pr[i], vf[e], acc[i][e]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the ring

  // sum the token slices' partials in the ring
  float* red = reinterpret_cast<float*>(ring);  // [TS][kRows][DH]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(ts * kRows + i) * DH + pv_dim<KIND, DH>(dq, e)] = acc[i][e];
  }
  if (lane == 0) {
    sml[warp] = m;
    sml[kRows + warp] = l;
  }
  __syncthreads();
  float* ws = reinterpret_cast<float*>(a.ws);
  const size_t nstate = (size_t)a.B * a.Hkv * a.nsplit * g.R;
  for (int e = tid; e < g.nrows * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < TS; ++t) sum += red[(t * kRows + i) * DH + d];
    if (direct) {
      const float li = sml[kRows + i];
      reinterpret_cast<__nv_bfloat16*>(a.out)[g.out_off(a, i, DH) + d] =
          __float2bfloat16(sum / (li == 0.f ? 1.f : li));
    } else {
      const size_t st = g.state(a, i, split);
      ws[2 * nstate + st * DH + d] = sum;
      if (d == 0) {
        ws[2 * st] = sml[i];
        ws[2 * st + 1] = sml[kRows + i];
      }
    }
  }
}

// Merge the splits of each query row: out = sum_s 2^(m_s - M) acc_s /
// sum_s 2^(m_s - M) l_s over the splits that reach the row's position.
template <int DH>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(const Args a) {
  const RowGroup g(a, blockIdx.x, blockIdx.y);
  if (g.q_last < a.split_tokens) return;  // written directly by its one split
  const float* ws = reinterpret_cast<const float*>(a.ws);
  const size_t nstate = (size_t)a.B * a.Hkv * a.nsplit * g.R;
  for (int e = threadIdx.x; e < g.nrows * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    const int ns = g.q_pos(i) / a.split_tokens + 1;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ws[2 * g.state(a, i, s)]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const size_t st = g.state(a, i, s);
      const float w = exp2f(ws[2 * st] - base);
      lsum += w * ws[2 * st + 1];
      acc += w * ws[2 * nstate + st * DH + d];
    }
    reinterpret_cast<__nv_bfloat16*>(a.out)[g.out_off(a, i, DH) + d] =
        __float2bfloat16(acc / (lsum == 0.f ? 1.f : lsum));
  }
}

template <int KIND, int DH>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = Smem<KIND, DH>::bytes;
  // the attribute is the current device's: set it once on each device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return dev_err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<KIND, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int groups = a.Hkv * ((a.T * (a.Hq / a.Hkv) + kRows - 1) / kRows);
  // blocks start in grid order, x fastest: with the split slowest, every
  // row's first split (always live) starts before the later splits, many
  // of which return at once
  paged_split_kernel<KIND, DH><<<dim3(groups, a.B, a.nsplit), kThreads, bytes, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  paged_merge_kernel<DH><<<dim3(groups, a.B), kThreads, 0, s>>>(a);
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
// ws: f32 workspace of B * Hkv * nsplit * T * (Hq / Hkv) * (Dh + 2) values,
// null when nsplit == 1 (the one split writes out directly).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* tables, const void* positions, void* out, void* ws, int B, int T, int Hq,
    int Hkv, int Dh, int page, int Pmax, int kind, float scale, int split_tokens, int nsplit,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (kind != kBf16 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (split_tokens < 1 || nsplit < 1 || (long long)split_tokens * nsplit < (long long)Pmax * page) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, ks, vs, tables, positions, out, ws, B, T, Hq, Hkv, page, Pmax,
               split_tokens, nsplit, scale * kLog2e};
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
