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
// (a negative position) gives 0, as the TPU kernel's _finish guards.
//
// What bounds it on an H100: a decode step reads every live K and V row of
// every (slot, KV head) once, DH + 8 bytes each with its two scales, and does
// ~4*DH operations per row per query head: a few operations per byte, so the
// bytes of the live cache at 3.35 TB/s bound it. Reaching that rate takes
// many SMs with many bytes in flight each, while a decode batch holds only
// B x Hkv strips (64 at B = 8) and one of them may be thousands of rows long
// while the others are short. The TPU kernel's shape (a sequential grid over
// S with the softmax state in scratch, all KV heads in one wide dot) has no
// use here. The design instead:
//   * splits each strip across blocks (flash-decoding): the grid is
//     (KV head x query-head group, slot, split), a split being split_rows
//     rows, and the number of splits follows from S alone (the wrapper's
//     split_plan), so the launch needs nothing from the device. A block
//     whose split starts past its slot's position returns at once. The
//     split is the slowest grid axis: blocks start in grid order, so every
//     strip's first split (always live) starts before the later splits,
//     most of which return at once on a ragged batch;
//   * has each block keep the G query heads of its KV head together (up to
//     4 at a time: the G = 4 heads of Llama-3-8B), so each K and V row is
//     read once per block, not once per query head;
//   * stages its split 64 rows at a time: a tile's K rows, V rows and their
//     scales are three contiguous runs of the strip, copied with 16-byte
//     (scales: 4-byte) cp.async into a two-stage ring, so the next tile's
//     bytes are in flight while this tile's scores, softmax and P.V run;
//     rows are padded by 16 bytes in shared memory, which keeps the reads
//     of neighbouring lanes free of bank conflicts; rows past the slot's
//     position are zero-filled, never read from memory, and weigh 0;
//   * scores from shared memory on the CUDA cores: each thread holds 16 dims
//     of the block's query heads in registers for the whole split and scores
//     several rows with them (int8 widens to f32 exactly), the parts'
//     partial dots summed through shared memory; one warp per query head
//     runs the online softmax in f32 with exp2; P.V has each thread own 4
//     output dims over a slice of the tile's rows;
//   * writes each live split's (max, sum, accumulator) to an f32 workspace;
//     the last block of a (slot, head group) to finish, found by an atomic
//     ticket, merges its splits by the log-sum-exp rule with the l == 0
//     guard. The last block rather than a second kernel: a second launch
//     cost the short serving rows (which need no merge at all) ~2 us of a
//     16 us call, and every decode step of the engine one more launch per
//     layer on a host-bound path. The tickets live in a small int32 buffer
//     that the wrapper zeroes once and keeps per stream; the merging block
//     sets its ticket back to 0, so every launch finds zeros. A slot whose
//     last live row lies in the first split writes its output directly and
//     takes no ticket; when the plan holds one split there is no workspace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// devices a process may launch on (the per-device attribute flags)
constexpr int kMaxDevices = 64;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // query heads a block (one softmax warp each)
static_assert(kThreads / 32 == kRows, "one warp a query head in the softmax");
constexpr int kTile = 64;  // cache rows a staged tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one block (byte offsets) and its work split.
template <int DH>
struct Smem {
  static constexpr int LDB = DH + 16;            // padded row stride
  static constexpr int CPR = DH / 16;            // 16-byte chunks a row
  static constexpr int NP = DH / 16;             // scoring parts of a row, 16 dims each
  static constexpr int TG = kThreads / NP;       // row stride of a scoring thread
  static constexpr int TPT = kTile / TG;         // rows a scoring thread scores a tile
  static constexpr int SD = NP * kRows + 1;      // padded stride of a row's partial dots
  static constexpr int DQ = DH / 4;              // dim quads of the P.V pass
  static constexpr int TS = kThreads / DQ;       // row slices of the P.V pass
  static constexpr int kv = 0;                   // [kStages][2][kTile][LDB]
  static constexpr int sc = kv + kStages * 2 * kTile * LDB;  // [kStages][2][kTile] f32
  static constexpr int qs = sc + kStages * 2 * kTile * 4;    // [kRows][DH] f32
  static constexpr int dot = qs + kRows * DH * 4;            // [kTile][SD] f32
  static constexpr int ps = dot + ((kTile * SD * 4 + 15) / 16) * 16;  // [kTile][kRows] f32
  static constexpr int alpha = ps + kTile * kRows * 4;       // [kRows] f32
  static constexpr int ml = alpha + kRows * 4;               // [2][kRows] f32
  static constexpr int bytes = ml + 2 * kRows * 4;
  static_assert(kThreads == 2 * kTile, "two threads stage each row of a tile");
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

struct Args {
  const __nv_bfloat16* q;  // [B, Hq, DH]
  const int8_t* k;         // [B, Hkv, S, DH]
  const float* ks;         // [B, Hkv, 1, S]
  const int8_t* v;
  const float* vs;
  const int* positions;    // [B]
  __nv_bfloat16* out;      // [B, Hq, DH]
  float* ws;               // (m, l) pairs then accumulators, see state()
  int* tickets;            // [B, gridDim.x], zero between launches
  int B, Hq, Hkv, S, split_rows, nsplit;
  float scale_log2;
};

// Which query heads a block serves, and how far their slot reaches.
struct HeadGroup {
  int b, kvh, r0, nrows, G, last;

  __device__ HeadGroup(const Args& a, int x, int by) {
    G = a.Hq / a.Hkv;
    const int ngroups = (G + kRows - 1) / kRows;
    b = by;
    kvh = x / ngroups;
    r0 = (x % ngroups) * kRows;
    nrows = min(kRows, G - r0);
    last = min(a.positions[b], a.S - 1);  // rows s <= last are live; < 0: none
  }
  // element offset of head i's vector in q and out [B, Hq, DH]
  __device__ size_t head_off(const Args& a, int i, int dh) const {
    return ((size_t)b * a.Hq + kvh * G + r0 + i) * dh;
  }
  // index of head i's state for split s in the workspace
  __device__ size_t state(const Args& a, int i, int s) const {
    return (((size_t)b * a.Hkv + kvh) * a.nsplit + s) * G + r0 + i;
  }
};

// Merge the splits of each query head of the group: out = sum_s 2^(m_s - M)
// acc_s / sum_s 2^(m_s - M) l_s over the splits that reach the slot's
// position. Other blocks wrote the states: read them past L1.
template <int DH>
__device__ void merge_splits(const Args& a, const HeadGroup& g, int ns) {
  const size_t nstate = (size_t)a.B * a.Hkv * a.nsplit * g.G;
  for (int e = threadIdx.x; e < g.nrows * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, __ldcg(a.ws + 2 * g.state(a, i, s)));
    const float base = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const size_t st = g.state(a, i, s);
      const float w = exp2f(__ldcg(a.ws + 2 * st) - base);
      lsum += w * __ldcg(a.ws + 2 * st + 1);
      acc += w * __ldcg(a.ws + 2 * nstate + st * DH + d);
    }
    a.out[g.head_off(a, i, DH) + d] = __float2bfloat16(acc / (lsum == 0.f ? 1.f : lsum));
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Args a) {
  using L = Smem<DH>;
  constexpr int LDB = L::LDB, CPR = L::CPR, NP = L::NP, TG = L::TG;
  constexpr int TPT = L::TPT, SD = L::SD, DQ = L::DQ, TS = L::TS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem + L::kv;
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* qs = reinterpret_cast<float*>(smem + L::qs);
  float* sdot = reinterpret_cast<float*>(smem + L::dot);
  float* ps = reinterpret_cast<float*>(smem + L::ps);
  float* salpha = reinterpret_cast<float*>(smem + L::alpha);
  float* sml = reinterpret_cast<float*>(smem + L::ml);

  const HeadGroup g(a, blockIdx.x, blockIdx.y);
  const int split = blockIdx.z;
  const int c0 = split * a.split_rows;
  const int tid = threadIdx.x;
  if (c0 > g.last) {  // the split starts past the slot's last live row
    if (split == 0) {  // no live row at all: the output is 0
      for (int e = tid; e < g.nrows * DH; e += kThreads) {
        a.out[g.head_off(a, e / DH, DH) + e % DH] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  const int c1 = min(c0 + a.split_rows, g.last + 1);
  const bool direct = g.last < a.split_rows;  // the slot's only split: no merge
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t strip = (size_t)g.b * a.Hkv + g.kvh;
  const int8_t* kb = a.k + strip * a.S * DH;
  const int8_t* vb = a.v + strip * a.S * DH;
  const float* ksb = a.ks + strip * a.S;
  const float* vsb = a.vs + strip * a.S;

  // Two threads stage each row of a tile: half the chunks of its K and V
  // rows each, and one of its two scales. Rows at or past c1 (another
  // split's, dead ones, the next strip's) are zero-filled, not read.
  auto issue = [&](int t0, int stage) {
    const int tok = tid % kTile, half = tid / kTile;
    const bool live = t0 + tok < c1;
    const int t = live ? t0 + tok : c0;
    uint8_t* kd = ring + ((stage * 2 + 0) * kTile + tok) * LDB;
    uint8_t* vd = ring + ((stage * 2 + 1) * kTile + tok) * LDB;
    const int8_t* ksrc = kb + (size_t)t * DH;
    const int8_t* vsrc = vb + (size_t)t * DH;
#pragma unroll
    for (int u = 0; u < CPR / 2; ++u) {
      const int c = half * (CPR / 2) + u;
      cp_async16(kd + c * 16, ksrc + c * 16, live ? 16 : 0);
      cp_async16(vd + c * 16, vsrc + c * 16, live ? 16 : 0);
    }
    cp_async4(sc + (stage * 2 + half) * kTile + tok, (half == 0 ? ksb : vsb) + t, live ? 4 : 0);
  };

  const int ntiles = (c1 - c0 + kTile - 1) / kTile;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {  // one group a tile, empty past the end
    if (it < ntiles) issue(c0 + it * kTile, it);
    cp_async_commit();
  }
  for (int e = tid; e < kRows * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    qs[e] = i < g.nrows ? __bfloat162float(a.q[g.head_off(a, i, DH) + d]) : 0.f;
  }
  __syncthreads();
  // scoring: part sp (16 dims) of rows tg + TG j, the query heads' dims of
  // that part held in registers for the whole split
  const int sp = tid % NP, tg = tid / NP;
  float qr[kRows][16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[i][e] = qs[i * DH + 16 * sp + e];
  }

  // softmax state of head `warp` (every lane holds it)
  float m = -INFINITY, l = 0.f;
  // P.V: dim quad dq over row slice ts
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
    for (int j = 0; j < TPT; ++j) {  // partial scores, one part of a row at a time
      const int tok = tg + TG * j;
      const uint4 raw = *reinterpret_cast<const uint4*>(ktile + tok * LDB + 16 * sp);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float kf[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) kf[e] = (float)(int8_t)((w[e / 4] >> (8 * (e % 4))) & 0xff);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) d = fmaf(qr[i][e], kf[e], d);
        sdot[tok * SD + sp * kRows + i] = d;
      }
    }
    __syncthreads();

    {  // online softmax of head `warp` over the tile's rows lane, lane + 32
      float s[2];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tok = u * 32 + lane;
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) dot += sdot[tok * SD + p * kRows + warp];
        const float fold = a.scale_log2 * sc[(stage * 2 + 0) * kTile + tok];
        s[u] = t0 + tok < c1 ? dot * fold : -INFINITY;
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
        ps[tok * kRows + warp] = p * sc[(stage * 2 + 1) * kTile + tok];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l = l * alpha + psum;
      m = m_new;
      if (lane == 0) salpha[warp] = alpha;
    }
    __syncthreads();

    {  // P.V over the tile's live rows
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
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vtile + tok * LDB + 4 * dq);
        float vf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) vf[e] = (float)(int8_t)((w >> (8 * e)) & 0xff);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pr[i], vf[e], acc[i][e]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the ring

  // sum the row slices' partials in the ring
  float* red = reinterpret_cast<float*>(ring);  // [TS][kRows][DH]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(ts * kRows + i) * DH + 4 * dq + e] = acc[i][e];
  }
  if (lane == 0) {
    sml[warp] = m;
    sml[kRows + warp] = l;
  }
  __syncthreads();
  const size_t nstate = (size_t)a.B * a.Hkv * a.nsplit * g.G;
  for (int e = tid; e < g.nrows * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < TS; ++t) sum += red[(t * kRows + i) * DH + d];
    if (direct) {
      const float li = sml[kRows + i];
      a.out[g.head_off(a, i, DH) + d] = __float2bfloat16(sum / (li == 0.f ? 1.f : li));
    } else {
      const size_t st = g.state(a, i, split);
      a.ws[2 * nstate + st * DH + d] = sum;
      if (d == 0) {
        a.ws[2 * st] = sml[i];
        a.ws[2 * st + 1] = sml[kRows + i];
      }
    }
  }
  if (direct) return;
  // the last of the slot's live splits to get here merges them all
  __shared__ int is_last;
  const int ns = g.last / a.split_rows + 1;
  __threadfence();  // this block's state is visible before its ticket
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + (size_t)g.b * gridDim.x + blockIdx.x;
    is_last = atomicAdd(ticket, 1) == ns - 1;
    if (is_last) *ticket = 0;  // every other split has drawn: ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  merge_splits<DH>(a, g, ns);
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = Smem<DH>::bytes;
  // the attribute is the current device's: set it once on each device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return dev_err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int groups = a.Hkv * ((a.Hq / a.Hkv + kRows - 1) / kRows);
  decode_split_kernel<DH><<<dim3(groups, a.B, a.nsplit), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Arguments in the order of the Python API: q, k_q, k_s, v_q, v_s, positions.
// ws: f32 workspace of B * Hq * nsplit * (Dh + 2) values, and tickets: int32
// [B * Hkv * ceil(G / 4)], all zero; both null when nsplit == 1 (the one
// split writes out directly).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* ks,
                                       const void* v, const void* vs, const void* positions,
                                       void* out, void* ws, void* tickets, int B, int Hq,
                                       int Hkv, int S, int Dh,
                                       float scale, int split_rows, int nsplit, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (split_rows < 1 || nsplit < 1 || (long long)split_rows * nsplit < S ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const int8_t*>(k),
               reinterpret_cast<const float*>(ks), reinterpret_cast<const int8_t*>(v),
               reinterpret_cast<const float*>(vs), reinterpret_cast<const int*>(positions),
               reinterpret_cast<__nv_bfloat16*>(out), reinterpret_cast<float*>(ws),
               reinterpret_cast<int*>(tickets),
               B, Hq, Hkv, S, split_rows, nsplit, scale * kLog2e};
  switch (Dh) {
    case 64:
      return (int)launch<64>(a, s);
    case 128:
      return (int)launch<128>(a, s);
    case 256:
      return (int)launch<256>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
