// Decode attention against a KV cache for Hopper (sm_90a), bfloat16.
//
// Replaces no Pallas kernel: the JAX package computes decode attention as
// two einsums (src/repro/models/attention.py, `decode_attention`), and the
// port's plain version (models/attention.py) as two batched products. On
// the card those products cannot read the cache [B, T, K, D] where it
// lies: each layer of each step first copies all of K and V into a
// [B*K, T, D] layout, reads the copy, and scores the cache's whole
// capacity with the slots past each row's length masked. This kernel was
// added to read every valid cached byte once, in place. It computes, for
// one new token per request,
//
//   s   = dot(q, k^T) in float32, then * D**-0.5        (scale from caller)
//   slots [0, n[b]) of row b only (the slots past it contribute exactly 0,
//   as the NEG_INF mask of the plain path gives)
//   online softmax over the slots with float32 m, l and acc, p rounded to
//   bf16 before p.v (as the prefill kernel does), l summing the float32 p
//   out = acc / max(l, 1e-30), rounded to bf16
//
// with `expf` and no fast math. q is [B, K, G, D] (query head (kh, g)
// reads KV head kh), the caches [B, T, K, D] through their strides, n [B]
// int32 on the card: nothing a step changes is read on the host, so a CUDA
// graph captured once replays right as the lengths grow; the grid comes
// from the shapes alone.
//
// Bound on an H100 SXM: bytes. A slot of one head is read once, 2*D bytes
// of K and V, and serves the G query heads of its group with 4*G*D FLOPs:
// 8 FLOPs a byte at G = 8, against the card's ridge of about 295. At
// yi-9b's decode (B = 64, K = 4, D = 128, 2,176 slots) a layer reads up to
// 285 MB, 85 us at 3.35 TB/s.
//
// What the design does about it: keep enough bytes in flight on every SM
// and touch each byte once.
//   * Split-K over the slots. The grid is (split, kv head, request); each
//     block takes `chunk` slots (a multiple of 64, chosen by the wrapper
//     from B*K and T so that several blocks run on each of the 132 SMs)
//     and stops at n[b], so the slots past a row's length are never read.
//     Four warps; the block streams 64-slot tiles of K and V (16 slots a
//     warp, 32 KB at D = 128) through a 2-stage ring of 16-byte cp.async
//     copies (a slot's row of one head is 2*D contiguous bytes), rows past
//     n[b] filled with zeros, so a NaN there cannot reach the products.
//   * The group computed once per loaded row: scores as mma.sync m16n8k16
//     with the slots as M and the G query heads as n = 8 (q zero-padded
//     to 8 or 16 heads in shared memory, n-tiles of 8 for G = 16), K
//     fragments by ldmatrix. p stays in registers: rounded to bf16, the
//     score tile's C layout is moved into the B layout of the transposed
//     product O^T = V^T . P by movmatrix, and V^T comes from shared memory
//     by ldmatrix.trans. The per-head m and l reduce over the 8 lanes that
//     share a column.
//   * Combine. The four warps' (m, l, acc) meet in shared memory at the
//     end of the block, which writes its split's float32 partial (acc and
//     its m and l: 3.1 MB a layer at yi-9b's shape, L2-resident); a second
//     small kernel combines the splits of each (request, kv head) by
//     logsumexp, reading only the splits that hold valid slots.
// No synchronisation with the host and no allocation: the wrapper
// allocates the output and the partials with torch.empty.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;        // slots a stage holds: 16 a warp
constexpr int kStages = 2;                // K/V ring depth
constexpr float kNegInf = -1e30f;

// Element offset of (row, col) in a tile of rows of DP bf16 whose 16-byte
// chunks are XOR-swizzled by row % 8: the 8 rows an ldmatrix reads at one
// logical chunk fall on 8 distinct bank groups.
template <int DP>
__device__ __forceinline__ int swz(int row, int col) {
  return row * DP + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// Shared memory of decode_attn_kernel<DP, NT>: q as NT*8 padded heads of
// DP columns, then kStages (K, V) tile pairs. After the last tile the ring
// holds the warps' partials: m and l [kWarps][NT*8][2], then acc
// [kWarps][NT*8][DP], float32.
template <int DP, int NT>
struct Smem {
  static constexpr int kQ = NT * 8 * DP;
  static constexpr int kKV = 2 * kTile * DP;  // one stage: K, then V
  static constexpr size_t kBytes =
      (size_t)(kQ + kStages * kKV) * sizeof(bf16);
  static constexpr size_t kCombine =
      (size_t)kWarps * NT * 8 * (2 + DP) * sizeof(float);
  static_assert(kCombine <= (size_t)kStages * kKV * sizeof(bf16),
                "the warps' partials must fit the ring");
};

// One block per (split, kv head, request): slots [s0, min(s0 + chunk, T,
// n[b])) of that head, partial (acc, m, l) of each query head written to
// part_o [split][B][KH][G][D] and part_ml [split][B][KH][G][2]. Warp w
// owns slots 16w .. 16w+15 of each tile. With r = lane/4 and t = lane%4,
// its score tile holds slots r, r+8 and heads 2t, 2t+1 (of n-tile nt);
// its O^T tiles hold columns d = 16*dm + r (+8) and the same heads, so
// one (m, l) pair per head column serves both products.
template <int DP, int NT>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ n,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int B, int T, int KH, int G, int D, int sb, int st, int sk,
                   int chunk, float scale) {
  using L = Smem<DP, NT>;
  extern __shared__ __align__(16) unsigned char smem_dec[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dec);
  bf16* KVs = Qs + L::kQ;                 // stage s: K, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int s0 = split * chunk;
  const int s_end = min(min(s0 + chunk, T), n[b]);
  if (s_end <= s0) return;  // no valid slot: the combine skips this split

  // padded heads and columns are zero: q's rows past G, and where D < DP
  // the columns of every tile past D (no copy writes them; the loop's
  // first barrier orders these stores before any read)
  {
    uint4* p = reinterpret_cast<uint4*>(smem_dec);
    if (D == DP) {
      for (int i = G * DP / 8 + tid; i < L::kQ / 8; i += kThreads)
        p[i] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int i = tid; i < (int)(L::kBytes / 16); i += kThreads)
        p[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();  // before the copies write the same words
    }
  }

  const bf16* k_base = k + b * sb + (long long)kh * sk;
  const bf16* v_base = v + b * sb + (long long)kh * sk;
  const int n_tiles = (s_end - s0 + kTile - 1) / kTile;
  constexpr int kChunks = DP / 8;         // 16-byte chunks of a row
  auto load_kv = [&](int j) {
    bf16* ks = KVs + (j % kStages) * L::kKV;
    const int t0 = s0 + j * kTile;
    const int valid = min(kTile, s_end - t0);
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (c < D) {
        const long long off = (long long)(t0 + min(r, valid - 1)) * st + c;
        ptx::cp_async16_zfill(ks + swz<DP>(r, c), k_base + off, r < valid);
        ptx::cp_async16_zfill(ks + kTile * DP + swz<DP>(r, c), v_base + off,
                              r < valid);
      }
    }
  };
  {
    const bf16* qh = q + (b * KH + kh) * G * D;
    for (int i = tid; i < G * kChunks; i += kThreads) {
      const int g = i / kChunks, c = (i % kChunks) * 8;
      if (c < D) ptx::cp_async16(Qs + swz<DP>(g, c), qh + g * D + c);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    ptx::cp_async_commit();               // q rides in tile 0's group
  }

  const int r = lane >> 2, t2 = (lane & 3) * 2;
  float m[NT][2], l[NT][2], acc[NT][DP / 16][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[nt][h] = kNegInf;
      l[nt][h] = 0.f;
    }
#pragma unroll
    for (int dm = 0; dm < DP / 16; ++dm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][dm][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    ptx::cp_async_wait<kStages - 2>();    // tile j (and q) landed
    __syncthreads();                      // ... for every thread; and tile
                                          // j-1's stage is free for j+1
    if (j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);
    ptx::cp_async_commit();
    const bf16* Ks = KVs + (j % kStages) * L::kKV;
    const bf16* Vs = Ks + kTile * DP;
    const int w0 = s0 + j * kTile + warp * 16;  // this warp's first slot
    // validity is a prefix: a warp past it has nothing to add here, and
    // this is the last tile
    if (w0 >= s_end) continue;

    // S^T = K . q^T: 16 slots x 8 heads an n-tile, two 16-deep steps per
    // ldmatrix of q
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DP / 32; ++kp) {
      uint32_t a0[4], a1[4];
      ptx::ldmatrix_x4(a0, Ks + swz<DP>(warp * 16 + (lane & 15),
                                        kp * 32 + (lane >> 4) * 8));
      ptx::ldmatrix_x4(a1, Ks + swz<DP>(warp * 16 + (lane & 15),
                                        kp * 32 + 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bq[4];  // B fragments of the two 16-deep steps
        ptx::ldmatrix_x4(bq, Qs + swz<DP>(nt * 8 + (lane & 7),
                                          kp * 32 + (lane >> 3) * 8));
        ptx::mma_bf16_16816(s[nt], a0, bq[0], bq[1]);
        ptx::mma_bf16_16816(s[nt], a1, bq[2], bq[3]);
      }
    }

    // online softmax per head column; element e is slot w0 + r + 8*(e/2),
    // head 2t + e%2 of its n-tile
    const bool tail = w0 + 16 > s_end;
    uint32_t pb[NT][2];                   // round(p) as B fragments of P.V
    float alpha[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bool ok[4];
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[e] = !tail || w0 + r + (e >> 1) * 8 < s_end;
        const float x = ok[e] ? s[nt][e] * scale : kNegInf;
        s[nt][e] = x;
        mx[e & 1] = fmaxf(mx[e & 1], x);
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
        const float m_new = fmaxf(m[nt][h], mx[h]);
        alpha[nt][h] = expf(m[nt][h] - m_new);
        m[nt][h] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ok[e] ? expf(s[nt][e] - m[nt][e & 1]) : 0.f;
        sum[e & 1] += s[nt][e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
        l[nt][h] = l[nt][h] * alpha[nt][h] + sum[h];
      }
      // rows r (slots 0-7) and r + 8 (slots 8-15), each an 8 x 8 matrix
      // of (slot, head), transposed into (slots 2t, 2t+1; head r)
      pb[nt][0] = ptx::movmatrix_trans(ptx::pack_bf16(s[nt][0], s[nt][1]));
      pb[nt][1] = ptx::movmatrix_trans(ptx::pack_bf16(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int dm = 0; dm < DP / 16; ++dm)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][dm][e] *= alpha[nt][e & 1];

    // O^T += V^T . P: 16 columns of D x 8 heads a tile, V^T by
    // transposing ldmatrix
#pragma unroll
    for (int dm = 0; dm < DP / 16; ++dm) {
      uint32_t av[4];
      ptx::ldmatrix_x4_trans(
          av, Vs + swz<DP>(warp * 16 + (lane >> 4) * 8 + (lane & 7),
                           dm * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ptx::mma_bf16_16816(acc[nt][dm], av, pb[nt][0], pb[nt][1]);
    }
  }

  // the four warps' partials meet in the ring's shared memory
  ptx::cp_async_wait<0>();
  __syncthreads();
  constexpr int kH = NT * 8;              // padded heads
  float* red_ml = reinterpret_cast<float*>(KVs);
  float* red_o = red_ml + kWarps * kH * 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = nt * 8 + t2 + h;
      if (r == 0) {
        red_ml[(warp * kH + g) * 2] = m[nt][h];
        red_ml[(warp * kH + g) * 2 + 1] = l[nt][h];
      }
    }
#pragma unroll
    for (int dm = 0; dm < DP / 16; ++dm)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = nt * 8 + t2 + (e & 1), d = dm * 16 + r + (e >> 1) * 8;
        red_o[(warp * kH + g) * DP + d] = acc[nt][dm][e];
      }
  }
  __syncthreads();
  const long long head0 = ((long long)split * B + b) * KH + kh;
  float* po = part_o + head0 * G * D;
  float* pml = part_ml + head0 * G * 2;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mw[kWarps], mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = red_ml[(w * kH + g) * 2];
      mb = fmaxf(mb, mw[w]);
    }
    float o = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(mw[w] - mb);
      o += red_o[(w * kH + g) * DP + d] * f;
      lb += red_ml[(w * kH + g) * 2 + 1] * f;
    }
    po[i] = o;
    if (d == 0) {
      pml[2 * g] = mb;
      pml[2 * g + 1] = lb;
    }
  }
}

// One block per (kv head, request), one warp per query head: each head's
// output from the splits that hold valid slots, combined by logsumexp in
// float32. The splits' m and l are read by every lane of the warp (a
// broadcast), the partial rows four columns a lane (float4).
__global__ void __launch_bounds__(32 * 16)
decode_combine_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ n, bf16* __restrict__ o, int B,
                      int T, int KH, int G, int D, int chunk) {
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = blockIdx.x;
  const long long b = blockIdx.y;
  const int valid = min(n[b], T);
  const int used = valid > 0 ? (valid + chunk - 1) / chunk : 0;
  const long long heads = (long long)B * KH * G;  // a split's heads
  const long long h0 = (b * KH + kh) * G + g;
  float mb = kNegInf;
  for (int s = 0; s < used; ++s)
    mb = fmaxf(mb, part_ml[2 * (s * heads + h0)]);
  float lsum = 0.f;
  for (int s = 0; s < used; ++s) {
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + 2 * (s * heads + h0));
    lsum += ml.y * expf(ml.x - mb);
  }
  const float denom = fmaxf(lsum, 1e-30f);
  for (int c = lane * 4; c < D; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < used; ++s) {
      const float f = expf(part_ml[2 * (s * heads + h0)] - mb);
      const float4 x =
          *reinterpret_cast<const float4*>(part_o + (s * heads + h0) * D + c);
      acc.x += x.x * f;
      acc.y += x.y * f;
      acc.z += x.z * f;
      acc.w += x.w * f;
    }
    __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(o + h0 * D + c);
    row[0] = __floats2bfloat162_rn(acc.x / denom, acc.y / denom);
    row[1] = __floats2bfloat162_rn(acc.z / denom, acc.w / denom);
  }
}

template <int DP, int NT>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* n,
           float* part_o, float* part_ml, bf16* o, int B, int T, int KH,
           int G, int D, int sb, int st, int sk, int splits, int chunk,
           float scale, cudaStream_t stream) {
  const size_t smem = Smem<DP, NT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<DP, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, KH, B);
  decode_attn_kernel<DP, NT><<<grid, kThreads, smem, stream>>>(
      q, k, v, n, part_o, part_ml, B, T, KH, G, D, sb, st, sk, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3(KH, B), 32 * G, 0, stream>>>(
      part_o, part_ml, n, o, B, T, KH, G, D, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, K, G, D] and o contiguous; the caches [B, T, K, D] with element
// strides (sb, st, sk) and unit stride along D, rows 16-byte aligned;
// n [B] int32; part_o [splits, B, K, G, D] and part_ml [splits, B, K, G,
// 2] float32 scratch; splits * chunk >= T, chunk a multiple of 64.
extern "C" int decode_attention_bf16(const __nv_bfloat16* q,
                                     const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const int* n,
                                     float* part_o, float* part_ml,
                                     __nv_bfloat16* o, int B, int T, int KH,
                                     int G, int D, int sb, int st, int sk,
                                     int splits, int chunk, float scale,
                                     cudaStream_t stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || G < 1 || G > 16 || T < 1 ||
      chunk < kTile || chunk % kTile != 0 || splits < 1 ||
      (long long)splits * chunk < T)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KH == 0) return (int)cudaGetLastError();
#define DECODE_LAUNCH(DP, NT)                                                \
  return launch<DP, NT>(q, k, v, n, part_o, part_ml, o, B, T, KH, G, D, sb, \
                        st, sk, splits, chunk, scale, stream)
  if (G <= 8) {
    if (D <= 64) DECODE_LAUNCH(64, 1);
    if (D <= 128) DECODE_LAUNCH(128, 1);
    DECODE_LAUNCH(256, 1);
  }
  if (D <= 64) DECODE_LAUNCH(64, 2);
  if (D <= 128) DECODE_LAUNCH(128, 2);
  DECODE_LAUNCH(256, 2);
#undef DECODE_LAUNCH
}
