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
// type before the product, as flash_attention.py:46 does. kv tiles wholly
// above the causal diagonal are skipped; they would add p = 0 at alpha = 1.
//
// Operands are read through strides, so one kernel serves both layouts:
//   q, o [B, S, KH, G, D] and k, v [B, T, KH, D]; query head (kh, g) reads
//   KV head kh in place (the Pallas contract [BH, S, D] is KH = G = 1).
//
// Bound on an H100 SXM: operations. The causal work is about S(S+1)/2
// scored pairs x 4*D flops per (batch, head); in bf16 its bound is the
// 989 TFLOP/s tensor-core peak. This first design runs on the CUDA cores
// (float32 FMA, 67 TFLOP/s peak), so it cannot approach that bound; wgmma,
// TMA and a pipelined K/V ring are later work.
//
// Design: one block of 128 threads per (64-row q tile, query head). The
// q tile stays in shared memory for the whole kv loop; each 64-row K and V
// tile is staged in shared memory in the input type. Thread (ty, tx) owns
// q rows ty*8 .. ty*8+7: for the scores it holds columns tx*4 .. tx*4+3 of
// the 64-wide tile, for the output columns tx, tx+16, ... of D, so the row
// statistics m and l it keeps serve both products. A row's 16 threads are
// one half-warp and reduce with shuffles. p (rounded to v's type) goes
// through shared memory between the two products. S and T must be
// multiples of 64 and D at most 128 (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
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

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int T_len,
           int KH, int G, int D, int causal, float scale,
           cudaStream_t stream) {
  if (D < 1 || D > kMaxD || S % kTile || T_len % kTile) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || S == 0 || KH == 0 || G == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kTile, B * KH * G);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, T_len, KH,
                                                    G, D, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// q, o: [B, S, KH, G, D]; k, v: [B, T, KH, D]; all contiguous, one type.

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int S,
                                   int T, int KH, int G, int D, int causal,
                                   float scale, cudaStream_t stream) {
  return launch(q, k, v, o, B, S, T, KH, G, D, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int S, int T, int KH, int G, int D,
                                    int causal, float scale,
                                    cudaStream_t stream) {
  return launch(q, k, v, o, B, S, T, KH, G, D, causal, scale, stream);
}
