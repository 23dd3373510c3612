// Forward flash attention for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py and computes exactly its function:
//
//   s    = dot(q, k^T) in float32, then * D**-0.5   (scale from the caller)
//   mask = kpos <= qpos (causal, both from 0: top-left), else NEG_INF=-1e30
//   online softmax over kv tiles with float32 m, l, acc:
//     m' = max(m, rowmax(s)); p = exp(s - m'); alpha = exp(m - m')
//     l  = l * alpha + rowsum(p); acc = acc * alpha + round_v(p) . v
//   out  = acc / max(l, 1e-30), rounded to q's type
//
// with `expf` (not `__expf`) and no fast math. `round_v(p)` rounds p to v's
// type before the product, as flash_attention.py:46 does, while l sums the
// float32 p. kv tiles wholly above the causal diagonal are skipped; they
// would add p = 0 at alpha = 1.
//
// Operands are read through strides, so one kernel serves both layouts:
//   q, o [B, S, KH, G, D] and k, v [B, T, KH, D]; query head (kh, g) reads
//   KV head kh in place (the Pallas contract [BH, S, D] is KH = G = 1).
//   Any S and T; D is at most 128 (the wrapper checks). Q rows past S are
//   loaded as zeros and never stored; K and V rows past T are loaded as
//   zeros (cp.async with a source size of 0) and their scores set to
//   NEG_INF, so p = 0 there and 0 . V adds nothing.
//
// Bound on an H100 SXM: operations. The causal work is about S(S+1)/2
// scored pairs x 4*D flops per (batch, head): 137 GFLOP at yi-9b's
// prefill (q [4, 2048, 4, 8, 128]), 0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak.
//
// bfloat16 (`flash_mma_kernel`, the serving path) runs on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, float32 accumulation), in the manner of
// FlashAttention-2. One block of 8 warps per (128-row q tile, query head);
// each warp owns 16 q rows, and a K/V tile read once serves all 128 (64-row
// q tiles halve that reuse and took 14% longer). The grid puts the G query
// heads that share a KV head next to each other, so their K and V tiles
// are read from L2, and runs the q tiles with the longest causal rows
// first. Q is loaded once and held in registers as mma A fragments
// (ldmatrix). K and V stream through a 2-stage ring of 64-row tiles in
// shared memory, filled by 16-byte cp.async copies, so tile j+1 loads
// while tile j computes (a third stage gained nothing); one barrier per
// tile. Tile rows are XOR-swizzled in 16-byte chunks, which
// keeps ldmatrix free of bank conflicts. S = Q.K^T takes K fragments by
// ldmatrix (a row-major K is the column-major B); the scale goes on the
// accumulator registers, the causal mask only on tiles that cross the
// diagonal (a warp skips a tile wholly above its rows), and row max and
// row sum reduce over the 4 threads of a quad. p is rounded to
// bf16 in registers, where the C layout of two adjacent m16n8 tiles is the
// A layout of one m16k16 tile, so O += P.V (V fragments by ldmatrix.trans)
// needs no trip through shared memory. Head dims are compiled for 64 and
// 128; a smaller D is zero-padded in shared memory (zeros add nothing to
// either product) and rows that are not 16-byte aligned (D % 8 != 0) load
// element by element. Measured on an H100 SXM: see PERF.md's kernel table.
// wgmma, TMA and warp specialisation would close the rest of the gap to the
// tensor-core bound; at 48 launches a prefill the GEMMs and elementwise
// passes around the kernel then dominate, so they are left for later.
//
// float32 (`flash_f32_kernel`, the Pallas contract, not on a serving
// path) stays on the CUDA cores in IEEE float32: tensor cores would
// compute it in TF32, which is not the Pallas float32 function. Its bound
// is the 67 TFLOP/s of the FMA pipes (2.05 ms at [128, 2048, 128]
// causal); what holds a CUDA-core kernel back from it is feeding the FMAs
// from shared memory and waiting for tiles. One block of 256 threads per
// (128-row q tile, query head), with the G query heads of a KV head side
// by side in the grid (their K and V tiles come from L2) and the longest
// causal rows first. Thread (ty, tx) owns q rows ty*8 .. ty*8+7 in both
// products, so the row statistics m and l it keeps serve both: an 8 x 4
// register block of scores (kv columns tx + 16c) and an 8 x DP/16 block of
// the output (columns g*64 + tx*4 ..). Both products read shared memory as
// float4 along their reduction: per 4 columns of D, 8 broadcast reads of
// Q and 4 of K (rows padded by 16 bytes, so a quarter-warp's 8 rows fall
// on 8 bank groups) feed 128 FMAs; per 4 kv rows, 8 broadcast reads of P
// and 4 * DP/64 of V feed 32 * DP/16. Reading along D needs no transposed
// copy of Q or K. Q is copied once; K and V stream through two stages
// filled by 16-byte cp.async, so tile j+1 loads while tile j computes, with
// one barrier per tile. A row's 16 threads are one half-warp: they reduce
// its max and sum with shuffles and are the only readers of the p they
// write, so P takes a __syncwarp, not a barrier. The mask applies only on
// tiles that cross a warp's diagonal, and a warp skips tiles wholly above
// its rows. Head dims are compiled for 64 and 128; a smaller D is
// zero-padded in shared memory and rows that are not 16-byte aligned
// (D % 4 != 0) load element by element. Shared memory is 226 KB at DP =
// 128, so one block runs on an SM. On an H100 SXM at 700 W (chip_smoke.py
// phase 2) it took 3.72-3.73 ms at [128, 2048, 128] causal, about 37
// TFLOP/s, against 3.24-3.28 ms for SDPA in float32 and 12.25 ms for the
// earlier design (64-row tiles loaded element by element, three barriers
// a tile).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kTile = 64;                 // kv rows per tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// ---- float32 on the CUDA cores ----------------------------------------------

constexpr int kFBM = 128;                 // q rows per block
constexpr int kFThreads = 256;            // 16 (ty) x 16 (tx)
constexpr int kFRows = kFBM / 16;         // q rows per thread: ty*8 + i
constexpr int kFCols = kTile / 16;        // scores per row: tx + 16c

// Shared memory of flash_f32_kernel<DP>, in floats: Q [128][DP], two
// stages of K [64][DP+4] and V [64][DP], P [128][64]. K's rows are padded
// by 16 bytes so that the 8 rows a quarter-warp reads fall on 8 distinct
// bank groups; Q and P are read by broadcast, V along its rows.
template <int DP>
struct FlashF32Smem {
  static constexpr int kKStride = DP + 4;
  static constexpr int kQ = kFBM * DP;
  static constexpr int kK = kTile * kKStride;
  static constexpr int kKV = kK + kTile * DP;   // one stage
  static constexpr int kP = kFBM * kTile;
  static constexpr size_t kBytes = (size_t)(kQ + 2 * kKV + kP) * sizeof(float);
};

// Copy rows [0, rows) x columns [0, D) of a float tile (row stride `ld` in
// global memory) to shared memory at row stride `stride`, rows from `valid`
// on as zeros (nothing past them is read): 16-byte cp.async where rows are
// 16-byte aligned (D % 4 == 0), else element by element.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* dst, int stride,
                                              const float* __restrict__ src,
                                              long long ld, int rows,
                                              int valid, int D) {
  if ((D & 3) == 0) {
    constexpr int kChunks = DP / 4;
    if (valid == rows) {   // a whole tile: no row to fill
      for (int i = threadIdx.x; i < rows * kChunks; i += kFThreads) {
        const int r = i / kChunks, c = (i % kChunks) * 4;
        if (c < D) ptx::cp_async16(dst + r * stride + c, src + r * ld + c);
      }
      return;
    }
    for (int i = threadIdx.x; i < rows * kChunks; i += kFThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      if (c < D)
        ptx::cp_async16_zfill(dst + r * stride + c,
                              src + min(r, valid - 1) * ld + c, r < valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kFThreads) {
      const int r = i / D, c = i - r * D;
      dst[r * stride + c] = r < valid ? src[r * ld + c] : 0.f;
    }
  }
}

// One block of 256 threads per (128-row q tile, query head). Thread
// (ty, tx) = (tid / 16, tid % 16) owns q rows ty*8 .. ty*8+7 in both
// products: scores in kv columns tx + 16c (c < 4), output columns
// g*64 + tx*4 .. +3 (g < DP/64). The 16 threads of a row are one
// half-warp, which reduces the row's max and sum with shuffles and is the
// only reader of the p it writes, so P needs a __syncwarp, not a barrier.
template <int DP>
__global__ void __launch_bounds__(kFThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int T_len, int KH, int G, int D, int causal, float scale) {
  using L = FlashF32Smem<DP>;
  constexpr int kOC = DP / 16;            // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* KVs = Qs + L::kQ;                // stage s: K, then V
  float* Ps = KVs + 2 * L::kKV;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = blockIdx.x;               // query head in its group
  const int kh = blockIdx.y % KH;
  const long long b = blockIdx.y / KH;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int q0 = qt * kFBM;

  const long long q_ld = (long long)KH * G * D;
  const long long kv_ld = (long long)KH * D;
  const long long q_off =
      ((b * S + q0) * KH + kh) * G * D + (long long)g * D;
  const float* k_base = k + (b * T_len * KH + kh) * D;
  const float* v_base = v + (b * T_len * KH + kh) * D;

  if (D != DP) {  // the padding columns stay zero: no copy writes them
    float4* p = reinterpret_cast<float4*>(smem_f32);
    for (int i = tid; i < (int)(L::kBytes / 16); i += kFThreads)
      p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // the last q tile may be short: rows from S on are loaded as zeros and
  // not stored, and the warps that own only such rows skip every tile; the
  // last kv tile may be short: its rows from T on are zeros, masked below
  const int q_rows = min(kFBM, S - q0);
  const int n_kv_all = (T_len + kTile - 1) / kTile;
  const int n_kv =
      causal ? min(n_kv_all, (q0 + q_rows - 1) / kTile + 1) : n_kv_all;
  auto load_kv = [&](int j) {
    float* ks = KVs + (j & 1) * L::kKV;
    const int rows = min(kTile, T_len - j * kTile);
    load_tile_f32<DP>(ks, L::kKStride, k_base + (long long)j * kTile * kv_ld,
                      kv_ld, kTile, rows, D);
    load_tile_f32<DP>(ks + L::kK, DP, v_base + (long long)j * kTile * kv_ld,
                      kv_ld, kTile, rows, D);
  };
  load_tile_f32<DP>(Qs, DP, q + q_off, q_ld, kFBM, q_rows, D);
  load_kv(0);
  ptx::cp_async_commit();

  float m[kFRows], l[kFRows], acc[kFRows][kOC];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOC; ++j) acc[i][j] = 0.f;
  }
  const int r0 = ty * kFRows;             // first of this thread's rows
  const int wq0 = q0 + (tid / 32) * 16;   // first q row of this warp
  const int dq = (D + 3) & ~3;            // Q, K columns past D are zero

  for (int j = 0; j < n_kv; ++j) {
    ptx::cp_async_wait<0>();  // tile j (and Q) landed
    __syncthreads();          // ... for every thread; tile j-1 is done
    if (j + 1 < n_kv) load_kv(j + 1);  // in flight during tile j
    ptx::cp_async_commit();
    const float* Ks = KVs + (j & 1) * L::kKV;
    const float* Vs = Ks + L::kK;
    const int k0 = j * kTile;
    // a warp past S, or whose every score in the tile is masked, has
    // nothing to add (p = 0 at alpha = 1)
    if (wq0 >= S || (causal && k0 > wq0 + 15)) continue;

    // S = Q . K^T: per 4 columns of D, 8 broadcast float4 reads of Q and
    // 4 of K feed 128 FMAs
    float s[kFRows][kFCols];
#pragma unroll
    for (int i = 0; i < kFRows; ++i)
#pragma unroll
      for (int c = 0; c < kFCols; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dq; d += 4) {
      float4 kv[kFCols];
#pragma unroll
      for (int c = 0; c < kFCols; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            Ks + (tx + 16 * c) * L::kKStride + d);
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (r0 + i) * DP + d);
#pragma unroll
        for (int c = 0; c < kFCols; ++c) {
          s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv.z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv.w, kv[c].w, s[i][c]);
        }
      }
    }

    // online softmax, row by row; the mask only on tiles that cross the
    // diagonal of this warp's rows or the end of K
    const bool diag = causal && k0 + kTile - 1 > wq0;
    const bool tail = k0 + kTile > T_len;
    const bool mask = diag || tail;
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kFCols; ++c) {
        float x = s[i][c] * scale;
        if (mask) {
          const int kpos = k0 + tx + 16 * c;
          if ((diag && kpos > qpos) || kpos >= T_len) x = kNegInf;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kFCols; ++c) {
        // p rounded to v's type is p itself in float32
        const float p = expf(s[i][c] - m_new);
        sum += p;
        Ps[(r0 + i) * kTile + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j2 = 0; j2 < kOC; ++j2) acc[i][j2] *= alpha;
    }
    __syncwarp();  // this half-warp's p rows are written

    // O += P . V: per 4 kv rows, 8 broadcast float4 reads of P and
    // 4 * DP/64 of V feed 32 * kOC FMAs
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 pv[kFRows];
#pragma unroll
      for (int i = 0; i < kFRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * kTile + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kOC / 4];
#pragma unroll
        for (int gq = 0; gq < kOC / 4; ++gq)
          vv[gq] = *reinterpret_cast<const float4*>(Vs + (c + u) * DP +
                                                    gq * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kFRows; ++i) {
          const float p = u == 0 ? pv[i].x
                        : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z
                                 : pv[i].w;
#pragma unroll
          for (int gq = 0; gq < kOC / 4; ++gq) {
            acc[i][gq * 4 + 0] = fmaf(p, vv[gq].x, acc[i][gq * 4 + 0]);
            acc[i][gq * 4 + 1] = fmaf(p, vv[gq].y, acc[i][gq * 4 + 1]);
            acc[i][gq * 4 + 2] = fmaf(p, vv[gq].z, acc[i][gq * 4 + 2]);
            acc[i][gq * 4 + 3] = fmaf(p, vv[gq].w, acc[i][gq * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    if (q0 + r0 + i >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = o + q_off + (long long)(r0 + i) * q_ld;
#pragma unroll
    for (int gq = 0; gq < kOC / 4; ++gq) {
      const int c = gq * 64 + tx * 4;
      if (c >= D) continue;
      const float4 x = make_float4(
          acc[i][gq * 4 + 0] / denom, acc[i][gq * 4 + 1] / denom,
          acc[i][gq * 4 + 2] / denom, acc[i][gq * 4 + 3] / denom);
      if ((D & 3) == 0) {
        *reinterpret_cast<float4*>(row + c) = x;
      } else {
        row[c] = x.x;
        if (c + 1 < D) row[c + 1] = x.y;
        if (c + 2 < D) row[c + 2] = x.z;
        if (c + 3 < D) row[c + 3] = x.w;
      }
    }
  }
}

// ---- bfloat16 on the tensor cores ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                 // one warp per 16 q rows
constexpr int kBM = 16 * kWarps;          // q rows per block
constexpr int kBN = 64;                   // kv rows per tile
constexpr int kStages = 2;                // K/V ring depth
constexpr int kMmaThreads = 32 * kWarps;

// Element offset of (row, col) in a tile of rows of DP bf16 whose 16-byte
// chunks are XOR-swizzled by row % 8: the 8 rows an ldmatrix reads at one
// logical chunk fall on 8 distinct bank groups.
template <int DP>
__device__ __forceinline__ int swz(int row, int col) {
  return row * DP + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// Q tile and kStages (K, V) tile pairs.
template <int DP>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)(kBM + 2 * kStages * kBN) * DP * sizeof(bf16);
}

// Issue the copy of rows [0, rows) x columns [0, D) of a tile (row stride
// `ld` elements in global memory) into its swizzled place, rows from
// `valid` on as zeros (nothing past them is read): 16-byte cp.async where
// rows are 16-byte aligned (D % 8 == 0), else element by element.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               long long ld, int rows,
                                               int valid, int D) {
  if ((D & 7) == 0) {
    constexpr int kChunks = DP / 8;
    if (valid == rows) {   // a whole tile: no row to fill
      for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
        const int r = i / kChunks, c = (i % kChunks) * 8;
        if (c < D) ptx::cp_async16(dst + swz<DP>(r, c), src + r * ld + c);
      }
      return;
    }
    for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (c < D)
        ptx::cp_async16_zfill(dst + swz<DP>(r, c),
                              src + min(r, valid - 1) * ld + c, r < valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kMmaThreads) {
      const int r = i / D, c = i - r * D;
      dst[swz<DP>(r, c)] = r < valid ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                 int T_len, int KH, int G, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* KVs = Qs + kBM * DP;  // stage s: K at KVs + s*2*kBN*DP, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x;                       // query head in its group
  const int kh = blockIdx.y % KH;
  const long long b = blockIdx.y / KH;
  const int qt = gridDim.z - 1 - blockIdx.z;      // longest causal rows first
  const int q0 = qt * kBM;

  const long long q_ld = (long long)KH * G * D;
  const long long kv_ld = (long long)KH * D;
  const long long q_off =
      ((b * S + q0) * KH + kh) * G * D + (long long)g * D;
  const bf16* k_base = k + (b * T_len * KH + kh) * D;
  const bf16* v_base = v + (b * T_len * KH + kh) * D;

  if (D != DP) {  // the padding columns stay zero: no copy writes them
    uint4* p = reinterpret_cast<uint4*>(smem_mma);
    for (int i = tid; i < (int)(mma_smem_bytes<DP>() / 16); i += kMmaThreads)
      p[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // the last q tile may be short: rows from S on are loaded as zeros and
  // not stored (each row's softmax and output are its own); the last kv
  // tile may be short: its rows from T on are zeros, masked below
  const int q_rows = min(kBM, S - q0);
  const int n_kv_all = (T_len + kBN - 1) / kBN;
  const int n_kv =
      causal ? min(n_kv_all, (q0 + q_rows - 1) / kBN + 1) : n_kv_all;
  auto load_kv = [&](int j) {
    bf16* ks = KVs + (j % kStages) * 2 * kBN * DP;
    const int rows = min(kBN, T_len - j * kBN);
    load_tile_bf16<DP>(ks, k_base + (long long)j * kBN * kv_ld, kv_ld, kBN,
                       rows, D);
    load_tile_bf16<DP>(ks + kBN * DP, v_base + (long long)j * kBN * kv_ld,
                       kv_ld, kBN, rows, D);
  };
  load_tile_bf16<DP>(Qs, q + q_off, q_ld, kBM, q_rows, D);  // in tile 0's
                                                            // group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kv) load_kv(s);
    ptx::cp_async_commit();
  }

  // this thread's rows of the warp's 16: r and r + 8 (h = 0, 1)
  const int wq0 = q0 + warp * 16;
  const int r = lane >> 2, t2 = (lane & 3) * 2;
  uint32_t qf[DP / 16][4];        // Q as A fragments, one per 16-deep step
  float acc[DP / 8][4];           // O: 8-column tiles, C layout
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    ptx::cp_async_wait<kStages - 2>();  // tile j (and Q) landed
    __syncthreads();                    // ... for every thread; and tile
                                        // j-1's stage is free for j+1
    if (j + kStages - 1 < n_kv) load_kv(j + kStages - 1);
    ptx::cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        ptx::ldmatrix_x4(qf[ks], Qs + swz<DP>(warp * 16 + (lane & 15),
                                              ks * 16 + (lane >> 4) * 8));
    }
    const bf16* Ks = KVs + (j % kStages) * 2 * kBN * DP;
    const bf16* Vs = Ks + kBN * DP;
    const int k0 = j * kBN;
    // a warp past S, or whose every score in the tile is masked, has
    // nothing to add (p = 0 at alpha = 1)
    if (wq0 >= S || (causal && k0 > wq0 + 15)) continue;

    // S = Q . K^T: 16 x 64 per warp, eight m16n8 tiles
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t kb[4];  // B fragments of n tiles 2np and 2np+1
        ptx::ldmatrix_x4(
            kb, Ks + swz<DP>(np * 16 + (lane >> 4) * 8 + (lane & 7),
                             ks * 16 + ((lane >> 3) & 1) * 8));
        ptx::mma_bf16_16816(s[2 * np], qf[ks], kb[0], kb[1]);
        ptx::mma_bf16_16816(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // online softmax; element e of a tile is row r + 8*(e/2), column
    // 2*(lane%4) + e%2
    const bool diag = causal && k0 + kBN - 1 > wq0;
    const bool tail = k0 + kBN > T_len;
    const bool mask = diag || tail;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (mask) {
          const int kpos = k0 + nt * 8 + t2 + (e & 1);
          if ((diag && kpos > wq0 + r + (e >> 1) * 8) || kpos >= T_len)
            x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    uint32_t pf[kBN / 16][4];   // round_v(p) as A fragments of P . V
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
      pf[nt / 2][(nt & 1) * 2] = ptx::pack_bf16(s[nt][0], s[nt][1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = ptx::pack_bf16(s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];

    // O += P . V: V fragments by transposing ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vb[4];  // B fragments of n tiles 2np and 2np+1
        ptx::ldmatrix_x4_trans(
            vb, Vs + swz<DP>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                             np * 16 + (lane >> 4) * 8));
        ptx::mma_bf16_16816(acc[2 * np], pf[kk], vb[0], vb[1]);
        ptx::mma_bf16_16816(acc[2 * np + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (wq0 + r + h * 8 >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* row = o + q_off + (long long)(warp * 16 + r + h * 8) * q_ld;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int c = nt * 8 + t2;
      const float x0 = acc[nt][2 * h] / denom, x1 = acc[nt][2 * h + 1] / denom;
      if (c >= D) continue;
      if ((D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        row[c] = __float2bfloat16(x0);
        if (c + 1 < D) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

// 0 where the kernels take the shape, else the error to return.
int check_shape(int S, int T_len, int D) {
  if (D < 1 || D > kMaxD || S < 0 || T_len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int DP>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int S, int T_len, int KH, int G, int D, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = FlashF32Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // x: the G query heads of one KV head side by side; z: q tiles
  const dim3 grid(G, B * KH, (S + kFBM - 1) / kFBM);
  flash_f32_kernel<DP><<<grid, kFThreads, smem, stream>>>(
      q, k, v, o, S, T_len, KH, G, D, causal, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
               int S, int T_len, int KH, int G, int D, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // x: the G query heads of one KV head side by side; z: q tiles
  const dim3 grid(G, B * KH, (S + kBM - 1) / kBM);
  flash_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, o, S, T_len, KH, G, D, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// q, o: [B, S, KH, G, D]; k, v: [B, T, KH, D]; all contiguous, one type,
// 16-byte aligned.

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int S,
                                   int T, int KH, int G, int D, int causal,
                                   float scale, cudaStream_t stream) {
  if (int err = check_shape(S, T, D)) return err;
  if (B == 0 || S == 0 || KH == 0 || G == 0) return (int)cudaGetLastError();
  return D <= 64 ? launch_f32<64>(q, k, v, o, B, S, T, KH, G, D, causal,
                                  scale, stream)
                 : launch_f32<128>(q, k, v, o, B, S, T, KH, G, D, causal,
                                   scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int S, int T, int KH, int G, int D,
                                    int causal, float scale,
                                    cudaStream_t stream) {
  if (int err = check_shape(S, T, D)) return err;
  if (B == 0 || S == 0 || KH == 0 || G == 0) return (int)cudaGetLastError();
  return D <= 64
             ? launch_mma<64>(q, k, v, o, B, S, T, KH, G, D, causal, scale,
                              stream)
             : launch_mma<128>(q, k, v, o, B, S, T, KH, G, D, causal, scale,
                               stream);
}
