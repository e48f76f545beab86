// Causal GQA flash attention for monolithic prefill, on the tensor cores.
//
// Replaces the Pallas TPU kernel generativeaiexamples_tpu/ops/flash_attention.py
// (_kernel, launched by flash_attention_causal): out[b, t, h] = softmax over
// keys s <= t of (q[b, t, h] . k[b, s, h // group]) / sqrt(D), times v. The
// T x T score matrix never reaches device memory.
//
// What bounds it on an H100: at B = 2, T = 512, Hq = 32, D = 128 the call
// does 4.3 GFLOP on 8.4 MB, 0.0043 ms at the bf16 tensor-core rate against
// 0.0063 ms for the bytes: it sits near the ridge, and off the tensor cores
// (67 TFLOP/s f32) the operations alone would take 0.064 ms. So both
// products run on the tensor cores, FlashAttention-2 style:
//   * one block per (64-row Q tile, q head, batch row), 4 warps of 16 query
//     rows each; q head h reads KV head h // group, so K/V are never
//     repeated in memory; the tiles near the end of the causal triangle (the
//     heaviest) launch first;
//   * Q is loaded once with cp.async and held in registers as mma A
//     fragments (ldmatrix) for the whole D;
//   * K and V come in 64-token tiles through a two-stage cp.async ring, so
//     the next tile loads while this one computes; shared-memory rows are
//     padded to D + 8 bf16, which makes every ldmatrix conflict-free; rows
//     past T are zero-filled;
//   * S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate), K
//     fragments by ldmatrix; the online softmax runs in registers with exp2
//     (log2 e folded into the scale), each row's max and sum reduced across
//     the 4 lanes that hold it; only the diagonal tile is masked, tiles
//     wholly above the diagonal are never visited;
//   * P is rounded to bf16 in registers and fed straight back as the A
//     operand of O += P V, V fragments by ldmatrix.trans. This rounding of p
//     is the one numeric difference from the plain version, which keeps p
//     in f32;
//   * a row whose sum stays 0 divides by 1 (the TPU kernel's l == 0 guard),
//     and only rows < T are written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// devices a process may launch on (the per-device attribute flags)
constexpr int kMaxDevices = 64;

namespace {

constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // keys a K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBQ + 4 * kBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, T, Hkv, D]
    __nv_bfloat16* __restrict__ out,      // [B, T, Hq, D]
    int T, int Hq, int Hkv, float scale_log2) {
  constexpr int LD = D + 8;   // shared row stride, bf16
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  constexpr int KD = D / 16;  // k-steps of Q K^T, and 16-wide column pairs of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][LD]
  __nv_bfloat16* Ks = Qs + kBQ * LD;                                // [2][kBK][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBK * LD;                            // [2][kBK][LD]

  // blocks start in grid order, x fastest: the q tile is the slowest axis,
  // reversed, so the heaviest tiles start first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kBQ * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const int tq = q0 + r;
    const __nv_bfloat16* src = q + (((size_t)b * T + min(tq, T - 1)) * Hq + h) * D + c * 8;
    cp_async16(Qs + r * LD + c * 8, src, tq < T ? 16 : 0);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    for (int i = tid; i < kBK * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const int tk = k0 + r;
      const size_t off = (((size_t)b * T + min(tk, T - 1)) * Hkv + kvh) * D + c * 8;
      const int n = tk < T ? 16 : 0;
      cp_async16(Ks + (stage * kBK + r) * LD + c * 8, k + off, n);
      cp_async16(Vs + (stage * kBK + r) * LD + c * 8, v + off, n);
    }
  };
  // tiles 0 .. qt: the last is the diagonal one (kBK == kBQ); its first key
  // q0 is < T, so every row meets at least one live key in every tile
  const int ntiles = qt + 1;
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8 (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of their running sums
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* Kt = Ks + (j & 1) * kBK * LD;
    const __nv_bfloat16* Vt = Vs + (j & 1) * kBK * LD;

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[kBK / 16][4];  // all loads of the k-step in flight before its mmas
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        ldmatrix_x4(kf[np], Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        mma_bf16(s[2 * np], qf[kk], kf[np][0], kf[np][1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[np][2], kf[np][3]);
      }
    }

    const int k0 = j * kBK;
    const bool diag = j == ntiles - 1;
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[n][e] * scale_log2;
        if (diag && (key > row || key >= T)) x = -INFINITY;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m[0] - base0);
    const float alpha1 = exp2f(m[1] - base1);
    m[0] = mx0;
    m[1] = mx1;
    l[0] *= alpha0;
    l[1] *= alpha1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        p[u][0] = exp2f(s[2 * kt + u][0] - base0);
        p[u][1] = exp2f(s[2 * kt + u][1] - base0);
        p[u][2] = exp2f(s[2 * kt + u][2] - base1);
        p[u][3] = exp2f(s[2 * kt + u][3] - base1);
        l[0] += p[u][0] + p[u][1];
        l[1] += p[u][2] + p[u][3];
      }
      const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                             pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // V loads of half the dims, then their mmas
        uint32_t vf[KD / 2][4];
#pragma unroll
        for (int u = 0; u < KD / 2; ++u) {
          const int dp = half * (KD / 2) + u;
          ldmatrix_x4_trans(vf[u], Vt + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       dp * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int u = 0; u < KD / 2; ++u) {
          const int dp = half * (KD / 2) + u;
          mma_bf16(o[2 * dp], a, vf[u][0], vf[u][1]);
          mma_bf16(o[2 * dp + 1], a, vf[u][2], vf[u][3]);
        }
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... for every thread, and this one is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + (lane & 3) * 2;
    if (row0 < T) {
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * T + row0) * Hq + h) * D + d) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    }
    if (row1 < T) {
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * T + row1) * Hq + h) * D + d) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int T,
                   int Hq, int Hkv, float scale, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<D>();
  // the attribute is the current device's: set it once on each device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return dev_err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  dim3 grid(Hq, B, (T + kBQ - 1) / kBQ);
  flash_attention_kernel<D><<<grid, kThreads, bytes, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(out), T, Hq,
      Hkv, scale * kLog2e);
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
