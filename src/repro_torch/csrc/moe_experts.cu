// The routed experts of a mixture-of-experts layer on one card, for Hopper
// (sm_90a), bfloat16: tokens grouped by expert, a grouped SwiGLU product
// and a grouped down product, dropless.
//
// Replaces no Pallas kernel: the JAX package computes every expert on
// every token (src/repro/models/moe.py, `moe_dense`) where it has no
// mesh, E / k times the routed work. Here each (token, k) assignment is
// one row of a padded buffer, at its expert's segment start plus its rank
// within the expert; each segment is padded to the row tile BM, so every
// tile of BM rows belongs to one expert. A table of `tiles` entries names
// each tile's expert, or -1 for the spare tiles past the last segment: its
// length depends on T*k, E and BM only, so the grids below come from
// shapes alone, nothing is read on the host, and a CUDA graph captured
// once replays right as the routing changes. The launches:
//
//   plan:    count, scan and place (`moe_plan`): each assignment's row and
//            the tile table, ranks in the assignments' order (stable)
//   gather:  xp[rows[a]] = x[a / k]                       (16-byte copies)
//   swiglu:  h = silu(xp . wg[e]) * (xp . wi[e])          (e: the tile's)
//            both products in float32 accumulators, silu and the product
//            in float32, h rounded once to bf16
//   down:    y = h . wo[e], float32 accumulators, rounded once to bf16
//   combine: out[t] = sum over j < k, in order, of bf16(w[t, j]) *
//            y[rows[t*k + j]], each product and sum rounded to float32 (no
//            FMA, no atomics: a replay repeats bit for bit), rounded once
//            to bf16
//
// The padding rows of xp are never written and their rows of h and y
// never read: a product row depends on its own row of the left operand
// alone.
//
// Bound on an H100 SXM: operations, where each expert gets a few hundred
// rows or more. At OLMoE's layer (T = 8192, k = 8, E = 64, D = 2048, F =
// 1024) a call does 6*T*k*D*F = 8.25e11 FLOPs of routed work, 0.83 ms at
// 989 TFLOP/s, against 0.8 GB of weights and 0.6 GB of rows moved. At
// decode (T = 64) every expert gets a few rows and the weights, read once,
// bound it.
//
// What the design does about it: each grouped product is `wgmma` fed by
// TMA, warp-specialised as `hgemm_wgmma_kernel` (matmul.cu): one producer
// warpgroup whose one thread keeps a ring of k-slots in flight, two
// consumer warpgroups, one block an SM walking units of (tile, column
// block): the tile table gives a unit's expert, which is the outer
// coordinate of the weights' rank-3 tensor map [E, K, N]; a spare tile's
// units are skipped. A unit is 128 x W (each consumer 64 rows) where the
// mean segment spans two tiles or more, else 64 x 2W (each consumer W
// columns of the same 64 rows), halving the padding and giving decode
// more units to stream the weights with. The SwiGLU unit holds the gate
// and the up accumulators (W = 128 each) and writes only h: the float32
// products never reach device memory, and no bf16 silu or product pass
// reads them back. On an H100 at OLMoE's prefill the SwiGLU product runs
// at about 64% of the bf16 peak and the down product, whose units are
// only 16 k-slots deep, at 45%.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                  // k per ring slot: 128-byte rows
constexpr uint32_t kBox = kBK * 64 * 2;  // one weight box: 64 k x 64 columns
constexpr int kConsumers = 2;            // warpgroups computing
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSwizzleBytes = 1024;      // 8 rows of 128 bytes
constexpr size_t kSmemBudget = 225 * 1024;

// A block of BM rows (64 or 128) by BN columns, each consumer 64 x W;
// GATED: two weight operands (gate and up), each W columns wide.
template <int BM, int W, bool GATED>
struct Shape {
  static constexpr int BN = BM == 128 ? W : 2 * W;
  static constexpr int kBand = BM == 128 ? 8 : 1;  // unit_of's band of tiles
  static constexpr int kOperands = GATED ? 2 : 1;
  static constexpr uint32_t kABytes = BM * kBK * 2;
  static constexpr uint32_t kBBytes = kBK * BN * 2;  // one operand
  static constexpr uint32_t kStageBytes = kABytes + kOperands * kBBytes;
  static constexpr int kStages =
      kSmemBudget / kStageBytes < 6 ? (int)(kSmemBudget / kStageBytes) : 6;
  static constexpr size_t kSmem = kStages * (size_t)kStageBytes +
                                  2 * kStages * sizeof(uint64_t) +
                                  kSwizzleBytes;
  static_assert(BM == 64 || BM == 128, "BM");
  static_assert(W % 64 == 0 && W <= 256 && (!GATED || W <= 128), "W");
  static_assert(kStages >= 3, "ring too short");
};

#define MOE_F8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[N/2] = A . B + (scale_d ? d : 0) for one 64 x N x 16 step: A K-major,
// B MN-major (trans-b = 1), bf16 in, float32 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_step<64>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MOE_F8(0), MOE_F8(8), MOE_F8(16), MOE_F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_step<128>(float* d, uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MOE_F8(0), MOE_F8(8), MOE_F8(16), MOE_F8(24), MOE_F8(32),
        MOE_F8(40), MOE_F8(48), MOE_F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_step<256>(float* d, uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MOE_F8(0), MOE_F8(8), MOE_F8(16), MOE_F8(24), MOE_F8(32),
        MOE_F8(40), MOE_F8(48), MOE_F8(56), MOE_F8(64), MOE_F8(72),
        MOE_F8(80), MOE_F8(88), MOE_F8(96), MOE_F8(104), MOE_F8(112),
        MOE_F8(120)
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef MOE_F8

// Unit u of a grouped product's tiles x column blocks: blocks walk bands
// of `band` tiles, the tiles of a band fastest, so that the units in
// flight share one expert's weight columns and its rows in L2 (8 tiles
// where an expert has several; 1, the column blocks fastest, where each
// has about one). Returns the tile's expert (-1: a spare tile) and its
// first row and column.
__device__ __forceinline__ int unit_of(const int* __restrict__ tiles, int u,
                                      int band, int nn, int n_tiles, int bm,
                                      int bn, int& m0, int& n0) {
  const int b = u / (band * nn);
  const int in_band = u - b * band * nn;
  const int band_tiles = min(band, n_tiles - b * band);
  const int tile = b * band + in_band % band_tiles;
  m0 = tile * bm;
  n0 = in_band / band_tiles * bn;
  return tiles[tile];
}

// C [n_tiles * BM, N] = A [n_tiles * BM, K] . B[e] tile by tile, e the
// tile's expert (GATED: silu(A . B0[e]) * (A . B1[e])), over units of one
// tile by BN columns. Persistent: block b takes units b, b + gridDim.x,
// ..., skipping the spare tiles'; producer and consumers count ring slots
// across units, so the loads of a block's next unit run during the
// epilogue of its current one. A slot holds A's BM rows x 64 k as
// 128-byte swizzled rows, then each operand's 64 k rows x BN columns as
// BN / 64 boxes of 64 x 64 (8 KB apart), all by TMA.
template <int BM, int W, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b0,
                    const __grid_constant__ CUtensorMap tma_b1,
                    const int* __restrict__ tiles, bf16* __restrict__ C,
                    int n_tiles, int N, int K) {
  using S = Shape<BM, W, GATED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleBytes - 1) &
      ~(uintptr_t)(kSwizzleBytes - 1));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;

  const int wg = threadIdx.x / 128;
  const int nn = (N + S::BN - 1) / S::BN, units = n_tiles * nn;
  const int nk = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      ptx::mbar_init(&full[s], 1);                 // the producer's expect_tx
      ptx::mbar_init(&empty[s], 4 * kConsumers);   // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: the whole warpgroup gives up registers, one thread loads
    ptx::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;  // slots filled so far
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0;
        const int expert =
            unit_of(tiles, u, S::kBand, nn, n_tiles, BM, S::BN, m0, n0);
        if (expert < 0) continue;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S::kStages;
          // round 0 passes
          ptx::mbar_wait(&empty[s], ((it / S::kStages) & 1) ^ 1);
          ptx::mbar_expect_tx(&full[s], S::kStageBytes);
          unsigned char* slot = ring + s * S::kStageBytes;
          ptx::tma_load_2d(slot, &tma_a, &full[s], kt * kBK, m0);
#pragma unroll
          for (int j = 0; j < S::BN / 64; ++j) {
            ptx::tma_load_3d(slot + S::kABytes + j * kBox, &tma_b0, &full[s],
                             n0 + 64 * j, kt * kBK, expert);
            if constexpr (GATED)
              ptx::tma_load_3d(slot + S::kABytes + S::kBBytes + j * kBox,
                               &tma_b1, &full[s], n0 + 64 * j, kt * kBK,
                               expert);
          }
        }
      }
    }
    return;
  }

  ptx::setmaxnreg_inc<232>();
  // A: K-major, this consumer's 64 rows (BM = 128) or the block's 64; a
  // 16-deep step is 32 bytes along the swizzled row. B: MN-major; LBO = 8
  // KB from one 64-column box to the next, SBO = 1 KB from one 8-row k
  // group to the next; a 16-deep step is 16 k rows, 2 KB.
  const uint32_t a0 =
      ptx::smem_addr(ring) + (BM == 128 ? wg * 64 * kBK * 2 : 0);
  const uint32_t b0 = ptx::smem_addr(ring) + S::kABytes +
                      (BM == 128 ? 0 : wg * (W / 64) * kBox);
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  float acc0[W / 2];
  float acc1[GATED ? W / 2 : 1];
  int it = 0;  // slots consumed so far
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, n0;
    if (unit_of(tiles, u, S::kBand, nn, n_tiles, BM, S::BN, m0, n0) < 0)
      continue;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S::kStages;
      ptx::mbar_wait(&full[s], (it / S::kStages) & 1);
      ptx::wgmma_fence();
      // the unit's first step overwrites the accumulators (scale-d = 0)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da =
            ptx::wgmma_desc(a0 + s * S::kStageBytes + kk * 32, 16, 1024);
        const uint32_t bs = b0 + s * S::kStageBytes + kk * 16 * 128;
        wgmma_step<W>(acc0, da, ptx::wgmma_desc(bs, kBox, 1024),
                      kt > 0 || kk > 0);
        if constexpr (GATED)
          wgmma_step<W>(acc1, da,
                        ptx::wgmma_desc(bs + S::kBBytes, kBox, 1024),
                        kt > 0 || kk > 0);
      }
      ptx::wgmma_commit();
      // the products of the previous slot are done: free it
      ptx::wgmma_wait<1>();
      if (kt > 0 && lane == 0)
        ptx::mbar_arrive(&empty[(it - 1) % S::kStages]);
    }
    ptx::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      ptx::reg_fence(acc0[i]);
      if constexpr (GATED) ptx::reg_fence(acc1[i]);
    }
    if (lane == 0) ptx::mbar_arrive(&empty[(it - 1) % S::kStages]);

    // accumulator i: row 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) +
    // 2*(lane%4) + i%2 of this consumer's 64 x W; every row lies inside
    // the padded buffer, columns past N are not stored
    const int row0 = m0 + (BM == 128 ? wg * 64 : 0) + warp * 16 + lane / 4;
    const int col0 = n0 + (BM == 128 ? 0 : wg * W) + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = col0 + 8 * j;  // even, and N is a multiple of 8
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        float v0 = acc0[i], v1 = acc0[i + 1];
        if constexpr (GATED) {
          v0 = v0 / (1.0f + __expf(-v0)) * acc1[i];
          v1 = v1 / (1.0f + __expf(-v1)) * acc1[i + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)(row0 + 8 * h) * N +
                                           col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The plan, in three launches over the A assignments in order, 32 a warp.
// Count: each warp's count of each expert, counts[w][e]. Scan (one block):
// the padded segments' starts and ends, each (warp, expert)'s first row in
// place of its count, the tile table. Place: each assignment's row, its
// (warp, expert)'s first row plus its rank among the warp's lanes of the
// same expert. Ranks follow the assignments' order: stable.
__global__ void plan_count_kernel(const long long* __restrict__ idx,
                                  int* __restrict__ counts, int A, int E) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= (A + 31) / 32) return;
  for (int e = lane; e < E; e += 32) counts[(long long)w * E + e] = 0;
  __syncwarp();
  const int a = w * 32 + lane;
  const int e = a < A ? (int)idx[a] : -1;
  const unsigned same = __match_any_sync(0xffffffffu, e);
  if (a < A && lane == __ffs(same) - 1)
    counts[(long long)w * E + e] = __popc(same);
}

__global__ void __launch_bounds__(1024)
plan_scan_kernel(int* __restrict__ counts, int* __restrict__ tiles, int W,
                 int E, int bm, int n_tiles) {
  extern __shared__ int sm[];
  const int parts = blockDim.x / E;  // each expert's warps in `parts` runs
  int* part = sm;                    // [parts][E]
  int* start = part + parts * E;     // [E]
  int* end = start + E;              // [E]
  const int tid = threadIdx.x, p = tid / E, e = tid % E;
  const int per = (W + parts - 1) / parts;
  const int w0 = min(W, p * per), w1 = min(W, w0 + per);
  if (p < parts) {
    int sum = 0;
    for (int w = w0; w < w1; ++w) sum += counts[(long long)w * E + e];
    part[p * E + e] = sum;
  }
  __syncthreads();
  if (tid < E) {
    int run = 0;
    for (int q = 0; q < parts; ++q) {
      const int c = part[q * E + tid];
      part[q * E + tid] = run;
      run += c;
    }
    end[tid] = (run + bm - 1) / bm * bm;  // the padded count, for now
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < E; ++i) {
      start[i] = run;
      run += end[i];
      end[i] = run;
    }
  }
  __syncthreads();
  if (p < parts) {
    int base = start[e] + part[p * E + e];
    for (int w = w0; w < w1; ++w) {
      const long long i = (long long)w * E + e;
      const int c = counts[i];
      counts[i] = base;
      base += c;
    }
  }
  // a tile's expert: the first whose segment ends past the tile's first row
  for (int i = tid; i < n_tiles; i += blockDim.x) {
    const long long row = (long long)i * bm;
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (end[mid] > row) hi = mid; else lo = mid + 1;
    }
    tiles[i] = lo < E ? lo : -1;
  }
}

__global__ void plan_place_kernel(const long long* __restrict__ idx,
                                  const int* __restrict__ base,
                                  int* __restrict__ rows, int A, int E) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= (A + 31) / 32) return;
  const int a = w * 32 + lane;
  const int e = a < A ? (int)idx[a] : -1;
  const unsigned same = __match_any_sync(0xffffffffu, e);
  if (a < A)
    rows[a] = base[(long long)w * E + e] + __popc(same & ((1u << lane) - 1));
}

// xp[rows[a]] = x[a / k] for the A assignments: a thread 16 bytes of a
// row (D % 8 == 0, rows 16-byte aligned), every copy in flight at once.
__global__ void gather_rows_kernel(const bf16* __restrict__ x,
                                   const int* __restrict__ rows,
                                   bf16* __restrict__ xp, int A, int k, int D) {
  const int per = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)A * per) return;
  const int a = (int)(i / per), c = (int)(i % per) * 8;
  *reinterpret_cast<uint4*>(xp + (long long)rows[a] * D + c) =
      *reinterpret_cast<const uint4*>(x + (long long)(a / k) * D + c);
}

// out[t] = sum_j bf16(w[t, j]) * y[rows[t*k + j]] in float32, j in order:
// a thread 8 columns of a token, the k rows' loads independent of the sums.
__global__ void combine_rows_kernel(const bf16* __restrict__ y,
                                    const int* __restrict__ rows,
                                    const float* __restrict__ w,
                                    bf16* __restrict__ out, int T, int k,
                                    int D) {
  const int per = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * per) return;
  const long long t = i / per;
  const int c = (int)(i % per) * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    const float wj = __bfloat162float(__float2bfloat16_rn(w[t * k + j]));
    const uint4 v = *reinterpret_cast<const uint4*>(
        y + (long long)rows[t * k + j] * D + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      acc[2 * e] = __fadd_rn(acc[2 * e], __fmul_rn(wj, f.x));
      acc[2 * e + 1] = __fadd_rn(acc[2 * e + 1], __fmul_rn(wj, f.y));
    }
  }
  uint4 o;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
  *reinterpret_cast<uint4*>(out + t * D + c) = o;
}

// Tensor map of a row-major [rows, cols] bf16 matrix read in boxes of
// box_rows x 64 columns (128 bytes), 128-byte swizzled.
bool encode_rows(ptx::EncodeTiled encode, CUtensorMap* map, const bf16* base,
                 int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of the experts' weights [E, K, N] read in boxes of 64 k rows
// x 64 columns of one expert, 128-byte swizzled; k and columns past the
// expert's read as zero.
bool encode_experts(ptx::EncodeTiled encode, CUtensorMap* map,
                    const bf16* base, int E, int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * sizeof(bf16),
                                 (cuuint64_t)K * N * sizeof(bf16)};
  const cuuint32_t box[3] = {64, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<bf16*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [tiles * BM, N] = A [tiles * BM, K] . B[e] tile by tile (GATED: the
// SwiGLU of B0 and B1).
template <int BM, int W, bool GATED>
int launch_grouped(ptx::EncodeTiled encode, const bf16* a, const bf16* b0,
                   const bf16* b1, const int* tiles, bf16* c, int n_tiles,
                   int E, int K, int N, cudaStream_t stream) {
  using S = Shape<BM, W, GATED>;
  CUtensorMap ta, tb0, tb1;
  if (!encode_rows(encode, &ta, a, n_tiles * BM, K, BM) ||
      !encode_experts(encode, &tb0, b0, E, K, N) ||
      !encode_experts(encode, &tb1, b1, E, K, N))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel<BM, W, GATED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  int device = 0, sms = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const long long units = (long long)n_tiles * ((N + S::BN - 1) / S::BN);
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  grouped_gemm_kernel<BM, W, GATED>
      <<<units < sms ? (int)units : sms, kThreads, S::kSmem, stream>>>(
          ta, tb0, tb1, tiles, c, n_tiles, N, K);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_experts(ptx::EncodeTiled encode, const bf16* x, const int* rows,
                   const int* tiles, const bf16* wg, const bf16* wi,
                   const bf16* wo, bf16* xp, bf16* h, bf16* y, int A, int k,
                   int n_tiles, int E, int D, int F, cudaStream_t stream) {
  // W: the SwiGLU's 128 columns a consumer (two accumulators), the down
  // product's 256; at BM = 64 (decode) 64 each, more blocks streaming the
  // weights (0.306 against 0.311 ms a layer of OLMoE's decode on an H100)
  constexpr int WG = BM == 128 ? 128 : 64, WD = BM == 128 ? 256 : 64;
  gather_rows_kernel<<<(int)(((long long)A * (D / 8) + 255) / 256), 256, 0,
                       stream>>>(x, rows, xp, A, k, D);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_grouped<BM, WG, true>(encode, xp, wg, wi, tiles, h, n_tiles, E,
                                     D, F, stream);
  if (err != 0) return err;
  return launch_grouped<BM, WD, false>(encode, h, wo, wo, tiles, y, n_tiles,
                                       E, F, D, stream);
}

}  // namespace

// x [T, D]; rows [T*k] int32, each assignment's row of the padded buffers
// (distinct, below tiles * bm); tiles [n_tiles] int32, each bm-row tile's
// expert or -1; wg, wi [E, D, F] and wo [E, F, D]; scratch xp [n_tiles *
// bm, D] and h [n_tiles * bm, F]; out y [n_tiles * bm, D]. All bf16
// contiguous and 16-byte aligned; bm 64 or 128; D % 8 == F % 8 == 0.
extern "C" int moe_experts_bf16(const __nv_bfloat16* x, const int* rows,
                                const int* tiles, const __nv_bfloat16* wg,
                                const __nv_bfloat16* wi,
                                const __nv_bfloat16* wo, __nv_bfloat16* xp,
                                __nv_bfloat16* h, __nv_bfloat16* y, int A,
                                int k, int n_tiles, int bm, int E, int D,
                                int F, cudaStream_t stream) {
  if ((bm != 64 && bm != 128) || D <= 0 || F <= 0 || D % 8 || F % 8 ||
      k <= 0 || E <= 0)
    return (int)cudaErrorInvalidValue;
  if (A == 0 || n_tiles == 0) return (int)cudaGetLastError();
  static const ptx::EncodeTiled encode = ptx::tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  return bm == 128
             ? launch_experts<128>(encode, x, rows, tiles, wg, wi, wo, xp, h,
                                   y, A, k, n_tiles, E, D, F, stream)
             : launch_experts<64>(encode, x, rows, tiles, wg, wi, wo, xp, h,
                                  y, A, k, n_tiles, E, D, F, stream);
}

// idx [A] int64, each assignment's expert in [0, E); rows [A] and tiles
// [n_tiles] int32 out; scratch [(A + 31) / 32 * E] int32; E <= 1024.
extern "C" int moe_plan(const long long* idx, int* rows, int* tiles,
                        int* scratch, int A, int E, int bm, int n_tiles,
                        cudaStream_t stream) {
  if (E <= 0 || E > 1024 || bm <= 0 || A < 0 || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (A == 0) return (int)cudaGetLastError();
  const int W = (A + 31) / 32;
  plan_count_kernel<<<(W + 7) / 8, 256, 0, stream>>>(idx, scratch, A, E);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int threads = 1024 / E * E;
  plan_scan_kernel<<<1, threads, (threads + 2 * E) * sizeof(int), stream>>>(
      scratch, tiles, W, E, bm, n_tiles);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  plan_place_kernel<<<(W + 7) / 8, 256, 0, stream>>>(idx, scratch, rows, A, E);
  return (int)cudaGetLastError();
}

// y [rows, D] bf16; rows [T*k] int32; w [T*k] float32; out [T, D] bf16;
// D % 8 == 0, all 16-byte aligned.
extern "C" int moe_combine_bf16(const __nv_bfloat16* y, const int* rows,
                                const float* w, __nv_bfloat16* out, int T,
                                int k, int D, cudaStream_t stream) {
  if (D <= 0 || D % 8 || k <= 0) return (int)cudaErrorInvalidValue;
  if (T > 0)
    combine_rows_kernel<<<(int)(((long long)T * (D / 8) + 255) / 256), 256, 0,
                          stream>>>(y, rows, w, out, T, k, D);
  return (int)cudaGetLastError();
}
