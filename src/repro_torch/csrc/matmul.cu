// Tiled matrix product for Hopper (sm_90a): C[M,N] = A[M,K] . B[K,N].
//
// Replaces the Pallas TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul.py (the DGEMM of the paper's section 4.1): the
// sum over k is kept in float32 and cast to the input type on store. Two
// arms:
//
//   matmul_f32   float32 in and out, IEEE float32 FMA (no TF32):
//                `sgemm_kernel`, the DGEMM's path;
//   matmul_bf16  bfloat16 in and out, float32 accumulation
//                (__bfloat162float on load, __float2bfloat16 on store):
//                `matmul_kernel`, on no main path.
//
// Bound on an H100 SXM: operations. 2*M*N*K flops over the card's peak:
// the float32 arm runs on the CUDA cores (67 TFLOP/s, 2.05 ms at
// M=N=K=4096); the bf16 arm's bound is the 989 TFLOP/s tensor-core peak
// (0.139 ms at 4096^3), which its CUDA-core FMAs cannot approach.
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
// bits. M and N must be multiples of 64 and K of 16 (the wrapper checks);
// a tile that overhangs N reads clamped columns and stores only the ones
// inside. On an H100 SXM at 700 W, 4096^3 took 2.88 ms against 2.65 for
// torch.matmul; 128x128 tiles of 8 warps took 2.94-2.96 ms, 8-deep steps
// 3.03-3.09 ms, one block of 8 warps to an SM 3.24 ms.
//
// bfloat16: the first design, 64x64 tiles of 16 k with a 4x4 register
// block per thread, one shared stage and two barriers per step; wgmma and
// TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;   // 16 x 16, each a 4x4 block of C
constexpr int kPadM = kBM + 4;  // A tile row stride: fewer bank conflicts

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(p[j]);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  for (int j = 0; j < 4; ++j) p[j] = __float2bfloat16(v[j]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[kBK][kPadM];  // As[k][m]
  __shared__ __align__(16) float Bs[kBK][kBN];    // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;        // output rows    ty*4 .. ty*4+3
  const long long row0 = (long long)blockIdx.y * kBM;
  const long long col0 = (long long)blockIdx.x * kBN;

  // loaders: A tile 64 rows x 16 k, B tile 16 k x 64 cols, 4 values each
  const int a_m = tid / 4, a_k = (tid % 4) * 4;
  const int b_k = tid / 16, b_n = (tid % 16) * 4;
  const T* a_src = A + (row0 + a_m) * K + a_k;
  const T* b_src = B + (long long)b_k * N + col0 + b_n;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    float va[4], vb[4];
    load4(a_src + k0, va);
    load4(b_src + (long long)k0 * N, vb);
    for (int j = 0; j < 4; ++j) As[a_k + j][a_m] = va[j];
    for (int j = 0; j < 4; ++j) Bs[b_k][b_n + j] = vb[j];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
      load4(&As[k][ty * 4], a);
      load4(&Bs[k][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    store4(C + (row0 + ty * 4 + i) * N + col0 + tx * 4, acc[i]);
}

// ---- float32: register-blocked, double-buffered SGEMM -------------------

// A BM x BN output tile per block of WM x WN warps, each warp a 32x64 tile
// and each thread an 8x8 block: rows m0 + {0..3, 16..19}, columns
// n0 + {0..3, 32..35}. Launched as <64, 128, 16, 2, 2, 4> only; kept a
// template because the same code written without one compiled to other
// register assignments and ran 7% slower (3.07 against 2.88 ms at 4096^3).
template <int BM, int BN, int BK, int WM, int WN, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K) {
  constexpr int T = 32 * WM * WN;
  static_assert(BM == 32 * WM && BN == 64 * WN, "warp tile 32x64");
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
  // loaders; rows and columns past M or N read the last valid ones
  const int a_m = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid / BQ, b_n = (tid % BQ) * 4;
  const float* a_src[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r)
    a_src[r] =
        A + (long long)min(row0 + a_m + r * (T / 2), M - 1) * K + a_k;
  const float* b_src = B + (long long)b_k * N + min(col0 + b_n, N - 4);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 ra[RP][KP];
  auto fetch = [&](int kt, int st) {  // B into stage st, A into ra
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
  };
  auto put = [&](int st) {  // ra, transposed, into stage st
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        As[st][a_k + 8 * i + 0][a_m + r * (T / 2)] = ra[r][i].x;
        As[st][a_k + 8 * i + 1][a_m + r * (T / 2)] = ra[r][i].y;
        As[st][a_k + 8 * i + 2][a_m + r * (T / 2)] = ra[r][i].z;
        As[st][a_k + 8 * i + 3][a_m + r * (T / 2)] = ra[r][i].w;
      }
  };
  fetch(0, 0);
  put(0);
  ptx::cp_async_wait<0>();
  __syncthreads();
  const int nk = K / BK;
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
      ptx::cp_async_wait<0>();
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
      if (col < N) store4(C + (long long)row * N + col, &acc[i][h * 4]);
    }
  }
}

int launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                __nv_bfloat16* c, int M, int N, int K, cudaStream_t stream) {
  if (M > 0 && N > 0 && K > 0) {
    matmul_kernel<__nv_bfloat16>
        <<<dim3(N / kBN, M / kBM), kThreads, 0, stream>>>(a, b, c, M, N, K);
  }
  return (int)cudaGetLastError();
}

int launch_f32(const float* a, const float* b, float* c, int M, int N, int K,
               cudaStream_t stream) {
  if (M > 0 && N > 0 && K > 0) {
    const dim3 grid((N + 127) / 128, (M + 63) / 64);
    sgemm_kernel<64, 128, 16, 2, 2, 4><<<grid, 128, 0, stream>>>(a, b, c, M,
                                                                 N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// All arrays are contiguous row-major and 16-byte aligned;
// M % 64 == N % 64 == K % 16 == 0.

extern "C" int matmul_f32(const float* a, const float* b, float* c, int M,
                          int N, int K, cudaStream_t stream) {
  return launch_f32(a, b, c, M, N, K, stream);
}

extern "C" int matmul_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                           __nv_bfloat16* c, int M, int N, int K,
                           cudaStream_t stream) {
  return launch_bf16(a, b, c, M, N, K, stream);
}
