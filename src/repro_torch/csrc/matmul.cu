// Tiled matrix product for Hopper (sm_90a): C[M,N] = A[M,K] . B[K,N].
//
// Replaces the Pallas TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul.py (the DGEMM of the paper's section 4.1): the
// sum over k is kept in float32 and cast to the input type on store. Two
// arms:
//
//   matmul_f32   float32 in and out, IEEE float32 FMA (no TF32):
//                `sgemm_kernel`, the DGEMM's path;
//   matmul_bf16  bfloat16 in and out, float32 accumulation, rounded once to
//                nearest even on store: `hgemm_wgmma_kernel`, on the tensor
//                cores, on no main path. Needs K and N multiples of 8:
//                TMA describes only row strides of 16-byte multiples;
//   matmul_bf16_fma  the same function for any K and N: `sgemm_kernel`
//                instantiated for bf16 loads (each converted to float,
//                IEEE FMA, rounded once on store), the wrapper's arm for
//                the shapes TMA cannot describe.
//
// Bound on an H100 SXM: operations. 2*M*N*K flops over the card's peak:
// the float32 arm runs on the CUDA cores (67 TFLOP/s, 2.05 ms at
// M=N=K=4096); the bf16 arm on the tensor cores (989 TFLOP/s, 0.139 ms).
//
// float32: what bounds an SGEMM on the CUDA cores is feeding the FMA pipes
// from shared memory and hiding the load latencies. Each thread holds an
// 8x8 register block, so four float4 shared reads feed 64 FMAs. Its block
// is 2x2 sub-blocks of 4x4, 16 rows and 32 columns apart inside its warp's
// 32x64 tile, so a warp's float4 reads of B cover 128 contiguous bytes and
// those of A 4 broadcast addresses: no bank conflicts. A block of 4 warps
// owns a 64x128 output tile, and four blocks share an SM (at most 128
// registers, no spills). k advances in steps of 16 through two shared
// stages: the next step's B tile is copied by 16-byte cp.async and its A
// tile read into registers (A is stored k-major, so it is transposed on
// the way) before the current step's FMAs, leaving one barrier per step;
// inside a step the operands of k+1 are read while k's FMAs run. Every
// output is one fmaf chain over k in increasing order from 0, as in the
// first design (64x64 tiles, one shared stage): the two give the same
// bits. Where M and N are multiples of 64 and K of 16 the loads are the
// ones described (a tile that overhangs N reads clamped columns and stores
// only the ones inside); any other shape runs the same loop with edge-safe
// loads (EDGE = true): both operands go through registers element by
// element, reads past M, N or K give zeros, and stores past M or N are
// skipped, so a row of K = 12 or N = 40 floats needs no alignment. Zeros
// past K add +0 to every chain: the results inside are the same bits.
// On an H100 SXM at 700 W, 4096^3 took 2.88 ms against 2.65 for
// torch.matmul; 128x128 tiles of 8 warps took 2.94-2.96 ms, 8-deep steps
// 3.03-3.09 ms, one block of 8 warps to an SM 3.24 ms.
//
// bfloat16: only the tensor cores reach the bound, and on Hopper only
// through wgmma, which reads its operands from shared memory while the
// products before it run. What bounds the kernel then is keeping the
// tensor cores fed: tiles must arrive without costing the consumers
// instructions, in the layout wgmma reads without bank conflicts. A block
// of three warpgroups computes 128 x 256 output tiles. The last
// warpgroup is the producer: one of its threads issues TMA copies of A's
// [128, 64] and B's [64, 256] tiles into a ring of four 48 KB slots in
// shared memory, each completing on the slot's "full" mbarrier; it gives
// up registers (setmaxnreg 40) to the two consumer warpgroups (232), each
// of which owns 64 rows of the tile, keeps 128 float32 accumulators a
// thread in registers and runs wgmma.m64n256k16 over the slot, then frees
// the slot on its "empty" mbarrier once the next slot's products are
// issued. TMA writes the tiles with the 128-byte swizzle that the wgmma
// descriptors name: A is K-major ([M, K] row-major), B is MN-major ([K, N]
// row-major, the transpose-B immediate) in four boxes of 64 k rows x 64
// columns. TMA fills reads past M, N or K with zeros, so a K tail
// (K % 64) and overhanging tiles add nothing; the epilogue stores only
// rows and columns inside C, as bf16 pairs rounded to nearest even. One
// block runs on each SM and walks its tiles, loading the next tile during
// the current one's epilogue. The tensor maps come from the driver's
// cuTensorMapEncodeTiled, found through the runtime's driver entry point
// (no link against libcuda), encoded on every call. Measured on an H100
// SXM at 700 W (chip_smoke.py phase 2, tools/kernel_variants.py): 4096^3
// in 0.208-0.220 ms, about 650 TFLOP/s, against 0.174-0.191 ms for
// torch.matmul; a call through the wrapper, encoding included, takes the
// kernel's own time. The variants, timed in turns with it by the tool: a
// block per tile instead of one per SM 2-3% slower, three slots 2-5%,
// accumulators zeroed by instructions at each tile instead of by the
// first step's scale-d = 0 0-2% (zeroing them once before the tile loop
// made ptxas serialize the products, its warning C7515). 128 x 128 tiles,
// and clusters of two blocks sharing B's boxes by TMA multicast, were
// tried in builds that are not kept and were not faster.
#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---- float32: register-blocked, double-buffered SGEMM -------------------

// A BM x BN output tile per block of WM x WN warps, each warp a 32x64 tile
// and each thread an 8x8 block: rows m0 + {0..3, 16..19}, columns
// n0 + {0..3, 32..35}. Launched as <64, 128, 16, 2, 2, 4> only; kept a
// template because the same code written without one compiled to other
// register assignments and ran 7% slower (3.07 against 2.88 ms at 4096^3).
// E is the element type in and out (float, or bf16 with EDGE); EDGE
// selects the edge-safe loads and stores for any M, N and K.
template <int BM, int BN, int BK, int WM, int WN, int MINB, typename E,
          bool EDGE>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
sgemm_kernel(const E* __restrict__ A, const E* __restrict__ B,
             E* __restrict__ C, int M, int N, int K) {
  constexpr int T = 32 * WM * WN;
  static_assert(BM == 32 * WM && BN == 64 * WN, "warp tile 32x64");
  static_assert(EDGE || sizeof(E) == 4, "16-byte copies take float only");
  constexpr int RP = BM / (T / 2), KP = BK / 8;      // A float4 a thread
  constexpr int BQ = BN / 4, NB = BK * BN / 4 / T;   // B copies a thread
  constexpr int PAD = BM + 4;  // As row stride: transposed stores fall on
                               // distinct banks
  __shared__ __align__(16) float As[2][BK][PAD];     // As[s][k][m]
  __shared__ __align__(16) float Bs[2][BK][BN];      // Bs[s][k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp / WN) * 32 + (lane >> 3) * 4;
  const int n0 = (warp % WN) * 64 + (lane & 7) * 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // loaders; rows and columns past M or N read the last valid ones (EDGE:
  // read zeros)
  const int a_m = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid / BQ, b_n = (tid % BQ) * 4;
  const E* a_src[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r)
    a_src[r] =
        A + (long long)min(row0 + a_m + r * (T / 2), M - 1) * K + a_k;
  const E* b_src = B + (long long)b_k * N +
                   (EDGE ? col0 + b_n : min(col0 + b_n, N - 4));
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 ra[RP][KP];
  float4 rb[EDGE ? NB : 1];
  // EDGE: element (row, k) of A and (k, col) of B, zero outside
  auto a_at = [&](int r, int k) -> float {
    return row0 + a_m + r * (T / 2) < M && k < K
               ? to_float(a_src[r][k - a_k]) : 0.f;
  };
  auto b_at = [&](int k, int col) -> float {
    return k < K && col < N ? to_float(B[(long long)k * N + col]) : 0.f;
  };
  auto fetch = [&](int kt, int st) {  // B into stage st, A into ra
    if constexpr (EDGE) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int k = kt * BK + b_k + i * (T / BQ), col = col0 + b_n;
        rb[i] = make_float4(b_at(k, col), b_at(k, col + 1),
                            b_at(k, col + 2), b_at(k, col + 3));
      }
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int i = 0; i < KP; ++i) {
          const int k = kt * BK + a_k + 8 * i;
          ra[r][i] = make_float4(a_at(r, k), a_at(r, k + 1), a_at(r, k + 2),
                                 a_at(r, k + 3));
        }
    } else {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        ptx::cp_async16(&Bs[st][b_k + i * (T / BQ)][b_n],
                        b_src + (long long)(kt * BK + i * (T / BQ)) * N);
      ptx::cp_async_commit();
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int i = 0; i < KP; ++i)
          ra[r][i] =
              *reinterpret_cast<const float4*>(a_src[r] + kt * BK + 8 * i);
    }
  };
  auto put = [&](int st) {  // ra, transposed, (EDGE: and rb) into stage st
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        As[st][a_k + 8 * i + 0][a_m + r * (T / 2)] = ra[r][i].x;
        As[st][a_k + 8 * i + 1][a_m + r * (T / 2)] = ra[r][i].y;
        As[st][a_k + 8 * i + 2][a_m + r * (T / 2)] = ra[r][i].z;
        As[st][a_k + 8 * i + 3][a_m + r * (T / 2)] = ra[r][i].w;
      }
    if constexpr (EDGE) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        *reinterpret_cast<float4*>(&Bs[st][b_k + i * (T / BQ)][b_n]) = rb[i];
    }
  };
  fetch(0, 0);
  put(0);
  if constexpr (!EDGE) ptx::cp_async_wait<0>();
  __syncthreads();
  const int nk = EDGE ? (K + BK - 1) / BK : K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch(kt + 1, cur ^ 1);  // in flight during this step's FMAs
    // the operands of k+1 load while k's FMAs run
    float a[2][8], b[2][8];
    load4(&As[cur][0][m0], a[0]);
    load4(&As[cur][0][m0 + 16], a[0] + 4);
    load4(&Bs[cur][0][n0], b[0]);
    load4(&Bs[cur][0][n0 + 32], b[0] + 4);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      if (k + 1 < BK) {
        load4(&As[cur][k + 1][m0], a[(k + 1) & 1]);
        load4(&As[cur][k + 1][m0 + 16], a[(k + 1) & 1] + 4);
        load4(&Bs[cur][k + 1][n0], b[(k + 1) & 1]);
        load4(&Bs[cur][k + 1][n0 + 32], b[(k + 1) & 1] + 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a[k & 1][i], b[k & 1][j], acc[i][j]);
    }
    if (more) {
      put(cur ^ 1);
      if constexpr (!EDGE) ptx::cp_async_wait<0>();
    }
    __syncthreads();  // the next stage is written and this one read
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + m0 + (i >> 2) * 16 + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + n0 + h * 32;
      if constexpr (EDGE) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N)
            store_elem(C + (long long)row * N + col + e, acc[i][h * 4 + e]);
      } else {
        if (col < N) store4(C + (long long)row * N + col, &acc[i][h * 4]);
      }
    }
  }
}

// ---- bfloat16: wgmma fed by TMA -----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kHBM = 128;                  // output rows per tile
constexpr int kHBN = 256;                  // output columns per tile
constexpr int kHBK = 64;                   // k per slot: 128-byte bf16 rows
constexpr int kHStages = 4;                // ring slots
constexpr int kHConsumers = 2;             // warpgroups of 64 rows each
constexpr int kHThreads = 128 * (kHConsumers + 1);
constexpr uint32_t kHABytes = kHBM * kHBK * 2;  // A: [128][64]
constexpr uint32_t kHBox = kHBK * 64 * 2;       // B box: [64 k][64 n]
constexpr uint32_t kHBBytes = kHBK * kHBN * 2;  // B: 4 boxes
constexpr int kSwizzleBytes = 1024;             // 8 rows of 128 bytes
// the ring, its barriers, and slack to align the ring to 1024 bytes
constexpr size_t kHSmem = kHStages * (size_t)(kHABytes + kHBBytes) +
                          2 * kHStages * sizeof(uint64_t) + kSwizzleBytes;

#define HG_F8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[128] = A . B + (scale_d ? d : 0) for one 64 x 256 x 16 step: A
// K-major, B MN-major (trans-b = 1), bf16 in, float32 accumulators.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t a,
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
      : HG_F8(0), HG_F8(8), HG_F8(16), HG_F8(24), HG_F8(32), HG_F8(40),
        HG_F8(48), HG_F8(56), HG_F8(64), HG_F8(72), HG_F8(80), HG_F8(88),
        HG_F8(96), HG_F8(104), HG_F8(112), HG_F8(120)
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef HG_F8

// Output tiles of 128 x 256, tile t at rows (t / tiles_n) * 128 and
// columns (t % tiles_n) * 256; block b takes tiles b, b + gridDim.x, ...
// Warpgroups 0 and 1 consume (64 rows each), warpgroup 2 produces. A slot
// holds A rows [m0, m0+128) x k [kt*64, +64) as 128 rows of 128 bytes,
// then B k rows [kt*64, +64) as four boxes of 64 k rows x 64 columns, all
// 128-byte swizzled by TMA. Producer and consumers count slots across
// tiles, so the loads of a block's next tile run during the epilogue of
// its current one.
__global__ void __launch_bounds__(kHThreads, 1)
hgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b,
                   bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleBytes - 1) &
      ~(uintptr_t)(kSwizzleBytes - 1));
  unsigned char* sB = sA + kHStages * kHABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kHStages * kHBBytes);
  uint64_t* empty = full + kHStages;

  const int wg = threadIdx.x / 128;
  const int tiles_n = (N + kHBN - 1) / kHBN;
  const int tiles = tiles_n * ((M + kHBM - 1) / kHBM);
  const int nk = (K + kHBK - 1) / kHBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      ptx::mbar_init(&full[s], 1);                 // the producer's expect_tx
      ptx::mbar_init(&empty[s], 4 * kHConsumers);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kHConsumers) {
    // producer: the whole warpgroup gives up registers, one thread loads
    ptx::setmaxnreg_dec<40>();
    if (threadIdx.x == kHConsumers * 128) {
      int it = 0;  // slots filled so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kHBM, n0 = t % tiles_n * kHBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kHStages;
          // round 0 passes
          ptx::mbar_wait(&empty[s], ((it / kHStages) & 1) ^ 1);
          ptx::mbar_expect_tx(&full[s], kHABytes + kHBBytes);
          ptx::tma_load_2d(sA + s * kHABytes, &tma_a, &full[s], kt * kHBK, m0);
#pragma unroll
          for (int j = 0; j < kHBN / 64; ++j)
            ptx::tma_load_2d(sB + s * kHBBytes + j * kHBox, &tma_b, &full[s],
                        n0 + 64 * j, kt * kHBK);
        }
      }
    }
  } else {
    ptx::setmaxnreg_inc<232>();
    // A: K-major, this warpgroup's 64 rows; a 16-deep step is 32 bytes
    // along the swizzled row. B: MN-major; LBO = 8 KB from one 64-column
    // box to the next, SBO = 1 KB from one 8-row k group to the next; a
    // 16-deep step is 16 k rows, 2 KB.
    const uint32_t a0 = ptx::smem_addr(sA) + wg * 64 * kHBK * 2;
    const uint32_t b0 = ptx::smem_addr(sB);
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float acc[kHBN / 2];
    int it = 0;  // slots consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kHStages;
        ptx::mbar_wait(&full[s], (it / kHStages) & 1);
        ptx::wgmma_fence();
        // the tile's first step overwrites the accumulators (scale-d = 0):
        // no other instruction writes them while products are in flight
#pragma unroll
        for (int kk = 0; kk < kHBK / 16; ++kk)
          wgmma_m64n256k16(
              acc, ptx::wgmma_desc(a0 + s * kHABytes + kk * 32, 16, 1024),
              ptx::wgmma_desc(b0 + s * kHBBytes + kk * 16 * 128, kHBox, 1024),
              kt > 0 || kk > 0);
        ptx::wgmma_commit();
        // the products of the previous slot are done: free it
        ptx::wgmma_wait<1>();
        if (kt > 0 && lane == 0) ptx::mbar_arrive(&empty[(it - 1) % kHStages]);
      }
      ptx::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kHBN / 2; ++i) ptx::reg_fence(acc[i]);
      if (lane == 0) ptx::mbar_arrive(&empty[(it - 1) % kHStages]);

      // accumulator i: row 16*warp + lane/4 + 8*((i/2)%2), column
      // 8*(i/4) + 2*(lane%4) + i%2 of this warpgroup's 64 x 256
      const int row0 = t / tiles_n * kHBM + wg * 64 + warp * 16 + lane / 4;
      const int col0 = t % tiles_n * kHBN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kHBN / 8; ++j) {
        const int col = col0 + 8 * j;  // even
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          bf16* out = C + (long long)row * N + col;
          if (col + 1 < N)  // a pair; the last odd column alone
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(
                acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          else
            *out = __float2bfloat16_rn(acc[4 * j + 2 * h]);
        }
      }
    }
  }
}

// Tensor map of a row-major [rows, cols] bf16 matrix read in boxes of
// box_rows x 64 columns (128 bytes), 128-byte swizzled; out-of-bounds
// elements read as zero.
bool encode_bf16(ptx::EncodeTiled encode, CUtensorMap* map, const bf16* base,
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

// One block per SM, each walking its tiles (a block per tile took 1-3%
// longer).
int launch_bf16(const bf16* a, const bf16* b, bf16* c, int M, int N, int K,
                cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  static const ptx::EncodeTiled encode = ptx::tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ta, tb;
  if (!encode_bf16(encode, &ta, a, M, K, kHBM) ||
      !encode_bf16(encode, &tb, b, K, N, kHBK)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      hgemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kHSmem);
  int device = 0, sms = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return (int)err;
  }
  const int tiles = (N + kHBN - 1) / kHBN * ((M + kHBM - 1) / kHBM);
  hgemm_wgmma_kernel<<<min(tiles, sms), kHThreads, kHSmem, stream>>>(
      ta, tb, c, M, N, K);
  return (int)cudaGetLastError();
}

template <typename E, bool EDGE>
int launch_sgemm(const E* a, const E* b, E* c, int M, int N, int K,
                 cudaStream_t stream) {
  if (M > 0 && N > 0 && K > 0) {
    const dim3 grid((N + 127) / 128, (M + 63) / 64);
    sgemm_kernel<64, 128, 16, 2, 2, 4, E, EDGE>
        <<<grid, 128, 0, stream>>>(a, b, c, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// All arrays are contiguous row-major and 16-byte aligned; matmul_bf16
// needs K % 8 == N % 8 == 0, the other two take any M, N, K.

extern "C" int matmul_f32(const float* a, const float* b, float* c, int M,
                          int N, int K, cudaStream_t stream) {
  return M % 64 == 0 && N % 64 == 0 && K % 16 == 0
             ? launch_sgemm<float, false>(a, b, c, M, N, K, stream)
             : launch_sgemm<float, true>(a, b, c, M, N, K, stream);
}

extern "C" int matmul_bf16_fma(const __nv_bfloat16* a,
                               const __nv_bfloat16* b, __nv_bfloat16* c,
                               int M, int N, int K, cudaStream_t stream) {
  return launch_sgemm<__nv_bfloat16, true>(a, b, c, M, N, K, stream);
}

extern "C" int matmul_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                           __nv_bfloat16* c, int M, int N, int K,
                           cudaStream_t stream) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  return launch_bf16(a, b, c, M, N, K, stream);
}

