// Mamba-2 SSD intra-chunk form for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel` / `ssd_chunk` in
// src/repro/kernels/ssd.py and computes its function, for every (batch x
// chunk) index b of x [BC, Q, H, P], dt [BC, Q, H], A [H], B, C [BC, Q, N]
// (ngroups = 1: one B and C row shared by all heads):
//
//   cs[s,h]      = cumsum_s(dt[s,h] * A[h])
//   y[l,h,p]     = sum_{s<=l} (C_l . B_s) * exp(cs[l,h] - cs[s,h])
//                             * (x[s,h,p] * dt[s,h])
//   states[h,p,n] = sum_s B_s[n] * (exp(cs[Q-1,h] - cs[s,h]) * dt[s,h])
//                             * x[s,h,p]
//
// both outputs in float32. The products are formed in that order, as the
// Pallas body forms them (w = scores * L, then w . xdt; decay * dt, then the
// contraction with B and x). `expf`, no fast math. Terms with s > l are
// skipped: the l tile visits only the s chunks at or below the diagonal,
// and inside the diagonal chunk no exponential is taken above it.
//
// The cumulative sum is a scan in double precision of the float products
// dt * A, each partial sum rounded to float. That is what torch.cumsum of a
// float32 tensor computes on the CPU (it accumulates in double), and what
// the plain version computes on the card (a float64 cumsum cast back);
// a float32 scan would drift by an ulp of |cs| (up to ~1e-4 relative at a
// 256-long chunk) from one summation order to the next.
//
// Bound on an H100 SXM: operations. At the Mamba-2 370m prefill's shapes
// (BC = 128, Q = 256, H = 32, P = 64, N = 128) the useful work is about
// 35.5 GFLOP (C.B^T over the causal half 1.1, y 17.2, states 17.2) against
// 0.71 GB of inputs and outputs: 0.53 ms at the 67 TFLOP/s float32 CUDA-core
// peak, 0.21 ms at 3.35 TB/s. This first design runs on the CUDA cores
// (float32 FMA); the tensor cores are later work.
//
// Design. The Pallas program holds a whole chunk (2 MB of x) and a q x q x h
// decay in VMEM; a Hopper block has 227 KB of shared memory, so the work is
// cut differently:
//
//  * ssd_y_kernel: one block of 256 threads per (b, group of 8 heads,
//    64-row l tile), heaviest (last) l tiles first. It scans cs for its
//    heads in shared memory (one warp per head), forms the 64 x (l0 + 64)
//    tile of scores C_l . B_s once, in 32-wide slices of N, and keeps it in
//    shared memory for its 8 heads. Per head and per 64-row s chunk it
//    forms W = scores * exp(cs_l - cs_s) and X = x * dt in shared memory
//    and accumulates W . X in registers: thread (ty, tx) owns rows
//    ty + 16i and columns tx + 16j (i, j < 4) of the 64 x 64 output tile.
//    107 KB of shared memory at Q = 256: two blocks per SM.
//  * ssd_states_kernel: one block of 256 threads per (b, head). It scans
//    cs, turns it into the weights exp(cs_last - cs_s) * dt_s, and
//    accumulates U^T . B over 32-row s chunks, U = x * weight: thread
//    (ty, tx) owns p = ty + 16i (i < 4) and n = tx + 16j (j < 8).
//
// Limits (the wrapper checks them): 1 <= Q <= 256, 1 <= P <= 64,
// 1 <= N <= 128, all tensors contiguous float32.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;            // l rows per tile, s rows per chunk (y)
constexpr int kThreads = 256;     // 16 (ty) x 16 (tx)
constexpr int kHG = 8;            // heads per y block: one warp each in the scan
constexpr int kNS = 32;           // N slice of the scores
constexpr int kSS = 32;           // s rows per chunk (states)
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLd = kT + 1;       // row stride of the 64-wide W and X tiles
constexpr int kSLd = kNS + 1;     // row stride of the C and B slices
constexpr int kBLd = kMaxN + 1;   // row stride of the states kernel's B rows

static_assert(kThreads / 32 == kHG, "one warp per head in the scan");

// In-place inclusive scan of row[0, len), summed in double and rounded to
// float at each position. Called by one whole warp; each lane takes a
// contiguous run of ceil(len / 32) entries.
__device__ void warp_scan(float* row, int len, int lane) {
  const int per = (len + 31) / 32;
  const int a = min(len, lane * per), b = min(len, a + per);
  double local = 0.0;
  for (int s = a; s < b; ++s) local += (double)row[s];
  double incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
  for (int s = a; s < b; ++s) {
    run += (double)row[s];
    row[s] = (float)run;
  }
}

// Floats of dynamic shared memory of the y kernel for Q rows.
inline size_t y_smem_floats(int Q) {
  const int nch = (Q + kT - 1) / kT;
  const size_t g = (size_t)kT * (nch * kT + 1);        // scores tile
  const size_t cs = (size_t)kHG * nch * kT;            // cs per head
  const size_t work = (size_t)2 * kT * kLd;            // W + X (>= C + B)
  return g + cs + work;
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ C, float* __restrict__ y, int Q,
             int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const int nch = (Q + kT - 1) / kT;
  const int g_ld = nch * kT + 1;
  const int cs_ld = nch * kT;
  float* Gs = smem;                         // [kT][g_ld]  scores C_l . B_s
  float* cs = Gs + kT * g_ld;               // [kHG][cs_ld]
  float* work = cs + kHG * cs_ld;
  float* Cs = work;                         // [kT][kSLd]  C slice
  float* Bs = work + kT * kSLd;             // [kT][kSLd]  B slice
  float* Ws = work;                         // [kT][kLd]   W, after the scores
  float* Xs = work + kT * kLd;              // [kT][kLd]   x * dt

  const long long b = blockIdx.x;
  const int h0 = blockIdx.y * kHG;
  const int nh = min(kHG, H - h0);
  const int t = gridDim.z - 1 - blockIdx.z;  // heaviest l tiles first
  const int l0 = t * kT;
  const int s_end = min(Q, l0 + kT);        // s < s_end can reach this tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  // cs[hh][s] for s < s_end: dt * A in float, then the scan
  for (int i = tid; i < s_end * kHG; i += kThreads) {
    const int s = i / kHG, hh = i - s * kHG;
    cs[hh * cs_ld + s] =
        hh < nh ? dt[(b * Q + s) * H + h0 + hh] * A[h0 + hh] : 0.f;
  }
  __syncthreads();
  warp_scan(cs + warp * cs_ld, s_end, lane);

  // scores Gs[l][s] = C_{l0+l} . B_s for the s chunks up to the diagonal
  for (int sc = 0; sc <= t; ++sc) {
    const int s0 = sc * kT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNS) {
      __syncthreads();                      // the slices' readers are done
      for (int i = tid; i < kT * kNS; i += kThreads) {
        const int r = i / kNS, c = i - r * kNS, n = n0 + c;
        Cs[r * kSLd + c] =
            (l0 + r < Q && n < N) ? C[(b * Q + l0 + r) * N + n] : 0.f;
        Bs[r * kSLd + c] =
            (s0 + r < Q && n < N) ? B[(b * Q + s0 + r) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kNS; ++c) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * kSLd + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * kSLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Gs[(ty + 16 * i) * g_ld + s0 + tx + 16 * j] = acc[i][j];
  }

  // per head: y[l0 + l, h, :] = sum over s chunks of W . X
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* csh = cs + hh * cs_ld;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int sc = 0; sc <= t; ++sc) {
      const int s0 = sc * kT;
      __syncthreads();                      // Gs and cs are complete; the
                                            // last W, X readers are done
      for (int i = tid; i < kT * kT; i += kThreads) {
        const int r = i / kT, c = i - r * kT, l = l0 + r, s = s0 + c;
        float w = 0.f;
        if (s <= l && l < Q) w = Gs[r * g_ld + s] * expf(csh[l] - csh[s]);
        Ws[r * kLd + c] = w;
      }
      for (int i = tid; i < kT * kMaxP; i += kThreads) {
        const int r = i / kMaxP, c = i - r * kMaxP, s = s0 + r;
        float v = 0.f;
        if (s < Q && c < P) {
          const long long row = (b * Q + s) * H + h;
          v = x[row * P + c] * dt[row];
        }
        Xs[r * kLd + c] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kT; ++k) {
        float wv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xs[k * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty + 16 * i;
      if (l >= Q) continue;
      float* out = y + ((b * Q + l) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) out[p] = acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ states, int Q, int H, int P, int N) {
  __shared__ float ws[kMaxQ];               // cs, then the weights
  __shared__ float Us[kSS * kLd];           // [s][p]  x * weight
  __shared__ float Bs[kSS * kBLd];          // [s][n]
  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const float a = A[h];
  for (int s = tid; s < Q; s += kThreads) ws[s] = dt[(b * Q + s) * H + h] * a;
  __syncthreads();
  if (tid < 32) warp_scan(ws, Q, tid);
  __syncthreads();
  const float cs_last = ws[Q - 1];
  __syncthreads();
  for (int s = tid; s < Q; s += kThreads)
    ws[s] = expf(cs_last - ws[s]) * dt[(b * Q + s) * H + h];

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s0 = 0; s0 < Q; s0 += kSS) {
    __syncthreads();                        // weights ready; readers done
    for (int i = tid; i < kSS * kMaxP; i += kThreads) {
      const int r = i / kMaxP, c = i - r * kMaxP, s = s0 + r;
      Us[r * kLd + c] = (s < Q && c < P)
                            ? x[((b * Q + s) * H + h) * P + c] * ws[s]
                            : 0.f;
    }
    for (int i = tid; i < kSS * kMaxN; i += kThreads) {
      const int r = i / kMaxN, c = i - r * kMaxN, s = s0 + r;
      Bs[r * kBLd + c] = (s < Q && c < N) ? B[(b * Q + s) * N + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kSS; ++k) {
      float uv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) uv[i] = Us[k * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[k * kBLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(uv[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    if (p >= P) continue;
    float* out = states + ((b * H + h) * P + p) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (n < N) out[n] = acc[i][j];
    }
  }
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError().
// x, y: [BC, Q, H, P]; dt: [BC, Q, H]; A: [H]; B, C: [BC, Q, N];
// states: [BC, H, P, N]; all contiguous float32.
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* A,
                             const float* B, const float* C, float* y,
                             float* states, int BC, int Q, int H, int P,
                             int N, cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      H < 1 || BC < 0 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (BC == 0) return (int)cudaGetLastError();
  const size_t smem = y_smem_floats(Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_y(BC, (H + kHG - 1) / kHG, (Q + kT - 1) / kT);
  ssd_y_kernel<<<grid_y, kThreads, smem, stream>>>(x, dt, A, B, C, y, Q, H, P,
                                                   N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_states_kernel<<<dim3(BC, H), kThreads, 0, stream>>>(x, dt, A, B, states,
                                                          Q, H, P, N);
  return (int)cudaGetLastError();
}
