// Tiled matrix product for Hopper (sm_90a): C[M,N] = A[M,K] . B[K,N].
//
// Replaces the Pallas TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul.py (the DGEMM of the paper's section 4.1): the
// sum over k is kept in float32 and cast to the input type on store. Two
// arms from one template:
//
//   matmul_f32   float32 in and out, IEEE float32 FMA (no TF32);
//   matmul_bf16  bfloat16 in and out, float32 accumulation
//                (__bfloat162float on load, __float2bfloat16 on store).
//
// Bound on an H100 SXM: operations. 2*M*N*K flops over the card's peak:
// the float32 arm runs on the CUDA cores (67 TFLOP/s, 2.05 ms at
// M=N=K=4096); the bf16 arm's bound is the 989 TFLOP/s tensor-core peak
// (0.139 ms at 4096^3), which these CUDA-core FMAs cannot approach.
//
// First design, right and simple: each block of 256 threads owns a 64x64
// output tile and walks k in steps of 16. A 64x16 tile of A (stored
// transposed, so a thread reads 4 consecutive rows as one float4) and a
// 16x64 tile of B sit in shared memory; each thread accumulates a 4x4
// register block. No double buffering, no tensor cores: wgmma and TMA are
// later work. M and N must be multiples of 64 and K of 16 (the wrapper
// checks, as the Pallas wrapper asserts divisibility).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
int launch(const T* a, const T* b, T* c, int M, int N, int K,
           cudaStream_t stream) {
  if (M > 0 && N > 0 && K > 0) {
    matmul_kernel<T><<<dim3(N / kBN, M / kBM), kThreads, 0, stream>>>(
        a, b, c, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// All arrays are contiguous row-major; M % 64 == N % 64 == K % 16 == 0.

extern "C" int matmul_f32(const float* a, const float* b, float* c, int M,
                          int N, int K, cudaStream_t stream) {
  return launch(a, b, c, M, N, K, stream);
}

extern "C" int matmul_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                           __nv_bfloat16* c, int M, int N, int K,
                           cudaStream_t stream) {
  return launch(a, b, c, M, N, K, stream);
}
