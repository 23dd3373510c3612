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
//   S and T are multiples of 64 and D is at most 128 (the wrapper checks).
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
// float32 (`flash_kernel`, the Pallas contract, not on a serving path)
// stays on the CUDA cores: tensor cores would compute it in TF32, which is
// not the Pallas float32 function. One block of 128 threads per (64-row q
// tile, query head); the q tile stays in shared memory and each 64-row K
// and V tile is staged there. Thread (ty, tx) owns q rows ty*8 .. ty*8+7:
// for the scores it holds columns tx*4 .. tx*4+3 of the 64-wide tile, for
// the output columns tx, tx+16, ... of D, so the row statistics m and l it
// keeps serve both products. A row's 16 threads are one half-warp and
// reduce with shuffles. p goes through shared memory between the two
// products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kTile = 64;                 // q rows and kv rows per tile
constexpr int kThreads = 128;             // 8 (ty) x 16 (tx)
constexpr int kRows = 8;                  // q rows per thread
constexpr int kCols = 4;                  // score columns per thread
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;         // output columns per thread
constexpr int kPStride = kTile + 1;       // p tile row stride (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Bytes of dynamic shared memory: q, k, v tiles (row stride D+1 elements of
// T, against bank conflicts) and the float p tile.
__host__ __device__ inline size_t tile_bytes(int D, size_t elt) {
  return ((size_t)kTile * (D + 1) * elt + 15) / 16 * 16;
}
inline size_t smem_bytes(int D, size_t elt) {
  return 3 * tile_bytes(D, elt) + (size_t)kTile * kPStride * sizeof(float);
}

// Copy a 64 x D tile (row stride `ld` elements in global memory) into
// shared memory at row stride D+1.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long ld, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * (D + 1) + d] = src[r * ld + d];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
             int KH, int G, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + tile_bytes(D, sizeof(T)));
  T* Vs = reinterpret_cast<T*>(smem + 2 * tile_bytes(D, sizeof(T)));
  float* Ps = reinterpret_cast<float*>(smem + 3 * tile_bytes(D, sizeof(T)));

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // longest causal rows first: the last q tile has the most kv tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const int head = blockIdx.y;            // (b, kh, g) over B*KH*G
  const int g = head % G;
  const int kh = (head / G) % KH;
  const long long b = head / (G * KH);

  const long long q_ld = (long long)KH * G * D;
  const long long kv_ld = (long long)KH * D;
  const T* q_base = q + ((b * S + q0) * KH + kh) * G * D + (long long)g * D;
  T* o_base = o + ((b * S + q0) * KH + kh) * G * D + (long long)g * D;
  const T* k_base = k + (b * T_len * KH + kh) * D;
  const T* v_base = v + (b * T_len * KH + kh) * D;

  load_tile(Qs, q_base, q_ld, D);

  float m[kRows], l[kRows], acc[kRows][kDPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }

  const int n_kv_all = T_len / kTile;
  const int n_kv = causal ? min(n_kv_all, qt + 1) : n_kv_all;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                      // previous tile's readers are done
    load_tile(Ks, k_base + (long long)k0 * kv_ld, kv_ld, D);
    load_tile(Vs, v_base + (long long)k0 * kv_ld, kv_ld, D);
    __syncthreads();

    // scores: rows ty*8+i, columns tx*4+c
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = to_f(Qs[(ty * kRows + i) * (D + 1) + d]);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv[c] = to_f(Ks[(tx * kCols + c) * (D + 1) + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // online softmax, row by row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float x = s[i][c] * scale;
        if (causal && k0 + tx * kCols + c > qpos) x = kNegInf;
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
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        Ps[(ty * kRows + i) * kPStride + tx * kCols + c] =
            to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDPer; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p . v: rows ty*8+i, output columns tx + 16*j
    for (int c = 0; c < kTile; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = Ps[(ty * kRows + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = to_f(Vs[c * (D + 1) + d]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o_base + (long long)(ty * kRows + i) * q_ld;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = from_f<T>(acc[i][j] / denom);
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
// `ld` elements in global memory) into its swizzled place: 16-byte cp.async
// where rows are 16-byte aligned (D % 8 == 0), else element by element.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               long long ld, int rows, int D) {
  if ((D & 7) == 0) {
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (c < D) ptx::cp_async16(dst + swz<DP>(r, c), src + r * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kMmaThreads) {
      const int r = i / D, c = i - r * D;
      dst[swz<DP>(r, c)] = src[r * ld + c];
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

  // the last q tile may hold only 64 rows: rows from S on are neither
  // loaded nor stored (each row's softmax and output are its own)
  const int q_rows = min(kBM, S - q0);
  const int n_kv_all = T_len / kBN;
  const int n_kv =
      causal ? min(n_kv_all, (q0 + q_rows - 1) / kBN + 1) : n_kv_all;
  auto load_kv = [&](int j) {
    bf16* ks = KVs + (j % kStages) * 2 * kBN * DP;
    load_tile_bf16<DP>(ks, k_base + (long long)j * kBN * kv_ld, kv_ld, kBN, D);
    load_tile_bf16<DP>(ks + kBN * DP, v_base + (long long)j * kBN * kv_ld,
                       kv_ld, kBN, D);
  };
  load_tile_bf16<DP>(Qs, q + q_off, q_ld, q_rows, D);  // in tile 0's group
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
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (diag && k0 + nt * 8 + t2 + (e & 1) > wq0 + r + (e >> 1) * 8)
          x = kNegInf;
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
  if (D < 1 || D > kMaxD || S % kTile || T_len % kTile) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int S, int T_len, int KH, int G, int D, int causal,
               float scale, cudaStream_t stream) {
  if (int err = check_shape(S, T_len, D)) return err;
  if (B == 0 || S == 0 || KH == 0 || G == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(D, sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kTile, B * KH * G);
  flash_kernel<float><<<grid, kThreads, smem, stream>>>(
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
  return launch_f32(q, k, v, o, B, S, T, KH, G, D, causal, scale, stream);
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
