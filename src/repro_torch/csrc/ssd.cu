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
// both outputs in float32, for any Q, H, P and N. `expf`, no fast math.
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
// peak, 0.21 ms at 3.35 TB/s. It runs on the CUDA cores (IEEE float32 FMA).
//
// Design. A chunk's x [Q, H, P] is a row-major [Q x H*P] matrix, and so is
// y; states [H, P, N] is a row-major [H*P x N] one. The decay is factored
// off the diagonal so that the heavy parts become plain products shared by
// all heads. For an l tile of 64 rows starting at l0 and any s < l0:
//
//   exp(cs_l - cs_s) = exp(cs_l - cs_{l0-1}) * exp(cs_{l0-1} - cs_s)
//
// so the off-diagonal part of y is diag(E_l) . G[l, s < l0] . Xh, with
// G = C . B^T (shared by every head), Xh[s, (h,p)] = F[s,h] * x[s,h,p],
// F[s,h] = exp(cs_{l0-1,h} - cs_{s,h}) * dt[s,h] and E[l,h] =
// exp(cs_{l,h} - cs_{l0-1,h}). Both factors lie in (0, 1] when cs does not
// increase over the chunk (dt >= 0 and A <= 0, as the model always gives),
// so neither can overflow. The Pallas function does not promise that, so
// the scan also sets a flag per (chunk, head), "cs does not increase"; a
// head whose flag is false gets F = E = 0, and its off-diagonal tiles take
// the direct form below instead. Five launches:
//
//  1. ssd_scan_kernel, a block per chunk: cs (one warp per head), the
//     flags, the states weights D[s,h] = exp(cs_{Q-1} - cs_s) * dt_s, E and
//     F: one exponential per (s, head) per l tile, one per (l, head).
//  2. ssd_scores_kernel: G = C . B^T once for the whole call, tiles wholly
//     above the diagonal skipped. G (Q x Q a chunk, 33.5 MB at the main
//     shape) is written once and read by the next launches, mostly from
//     the 50 MB L2; computing it inside ssd_y_kernel would repeat it for
//     every pair of head slices (16 times at the main shape).
//  3. ssd_y_kernel: per (chunk, l tile, two 64-column slices of H*P), one
//     register-blocked product over s: the steps below l0 take A = G rows
//     (shared by every head) and B = F * x formed as it is loaded, then
//     the accumulators are scaled by E; the 4 steps of the diagonal tile
//     take A = W_h = G o exp(cs_l - cs_s) masked to s <= l, formed per
//     head as it is loaded (the direct form: a factor there could overflow
//     when the decay inside 64 rows passes e^88), and B = dt * x. y is
//     written once.
//  4. ssd_direct_kernel: for a head whose flag is 0, every s tile below the
//     diagonal in the direct form, added to y (blocks of other heads
//     return at once).
//  5. ssd_states_kernel: [H*P x Q] . [Q x N], A = (x * D)^T, B the chunk's
//     B rows, shared by every head.
//
// Launches 2, 3 and 5 run the register-blocked, double-buffered SGEMM
// structure of sgemm_kernel in matmul.cu: 128 threads own a 64 x 128
// output tile, each an 8 x 8 register block fed by four float4 shared
// reads per 64 FMAs; the next 16-deep step is loaded into registers (and
// scaled or formed) during the current one's FMAs, one barrier per step.
// Edges are predicated: reads past M, N or K give zeros and stores past
// them are skipped. The product order differs from the Pallas body (w =
// scores * L, then w . xdt): sums of the same terms, held to 1e-4 of the
// output's largest magnitude.
//
// Memory: the caller provides a float32 workspace of
// ssd_workspace_floats(BC, Q, H) floats: BC * (H * Q * (3 + ceil(Q/64))
// + H + Q * 64 * ceil(Q/64)), 62 MB at the main shape.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;            // rows of an l or s tile
constexpr int kBM = 64, kBN = 128, kBK = 16;   // GEMM tile
constexpr int kGThreads = 128;    // GEMM: 4 warps of 32 x 64
constexpr int kAP = kBM + 4;      // As row stride: transposed stores fall on
                                  // distinct banks
constexpr int kScanThreads = 256;
constexpr int kDThreads = 128;    // direct kernel: 8 x 16 threads
constexpr int kDHeads = 8;        // heads per direct block
constexpr int kWP = kT + 4;       // row stride of the W and X tiles

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

// The workspace, carved from one float buffer; G first, so that its rows
// (Qp floats each) are 16-byte aligned for float4 access.
struct Work {
  float* G;      // [BC][Q][Qp]: C_l . B_s at and below the diagonal tiles
  float* cs;     // [BC][H][Q]
  float* flag;   // [BC][H]: 1 where cs does not increase over the chunk
  float* D;      // [BC][Q][H]: exp(cs_{Q-1} - cs_s) * dt_s
  float* E;      // [BC][Q][H]: exp(cs_l - cs_{l0-1}) (0 for l0 = 0 or flag 0)
  float* F;      // [BC][T][Q][H]: exp(cs_{64t-1} - cs_s) * dt_s, s < 64t
};

struct Dims {
  int BC, Q, H, P, N;
  int T, Qp, HP;   // l tiles, Q rounded up to a tile, H * P
  int PS;          // 64-column slices of a head's P columns
};

inline long long workspace_floats(long long BC, long long Q, long long H) {
  const long long T = (Q + kT - 1) / kT;
  return BC * (H * Q * (3 + T) + H + Q * T * kT);
}

Work carve(float* w, const Dims& d) {
  Work k;
  const long long bc = d.BC, q = d.Q, h = d.H;
  k.G = w;
  k.cs = k.G + bc * q * d.Qp;
  k.flag = k.cs + bc * h * q;
  k.D = k.flag + bc * h;
  k.E = k.D + bc * q * h;
  k.F = k.E + bc * q * h;
  return k;
}

// ---- 1. scan, flags and factors --------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                Work w, Dims d) {
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int Q = d.Q, H = d.H;
  for (int h = warp; h < H; h += kScanThreads / 32) {
    float* row = w.cs + (b * H + h) * Q;
    bool nonpos = true;
    for (int s = lane; s < Q; s += 32) {
      const float v = dt[(b * Q + s) * H + h] * A[h];
      row[s] = v;
      nonpos = nonpos && v <= 0.f;
    }
    __syncwarp();
    warp_scan(row, Q, lane);
    const bool mono = __all_sync(0xffffffffu, nonpos);
    if (lane == 0) w.flag[b * H + h] = mono ? 1.f : 0.f;
  }
  __syncthreads();  // cs and the flags of every head, for every thread
  for (int i = tid; i < Q * H; i += kScanThreads) {
    const int s = i / H, h = i - s * H;
    const float* row = w.cs + (b * H + h) * Q;
    const float c = row[s];
    const float dts = dt[(b * Q + s) * H + h];
    const bool mono = w.flag[b * H + h] != 0.f;
    const long long at = (b * Q + s) * H + h;
    w.D[at] = expf(row[Q - 1] - c) * dts;
    const int l0 = s / kT * kT;
    w.E[at] = mono && l0 > 0 ? expf(c - row[l0 - 1]) : 0.f;
    for (int t = s / kT + 1; t < d.T; ++t)
      w.F[((b * d.T + t) * Q + s) * H + h] =
          mono ? expf(row[t * kT - 1] - c) * dts : 0.f;
  }
}

// ---- the shared GEMM tile ---------------------------------------------------

enum Mode { kScores, kStates };

// One 64 x 128 tile of out = A . B over k in [0, K), rows from m_base and
// columns from n_base of the problem, per mode:
//   kScores  A = C rows [Q x N] (row-major), B(k, n) = Bm[n][k]; out = G;
//   kStates  A(m, k) = x[k][m] * D[k, h(m)] (k-major), B = Bm [Q x N];
//            out = states.
// Thread (warp, lane) owns rows m0 + {0..3, 16..19} and columns
// n0 + {0..3, 32..35} of the tile.
template <Mode MODE>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ a, long long lda, const float* __restrict__ bsrc,
    long long ldb, float* __restrict__ out, long long ldc, int M, int Nn,
    int K, int m_base, int n_base, const float* __restrict__ kscale,
    int H, int P) {
  __shared__ __align__(16) float As[2][kBK][kAP];   // As[s][k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // Bs[s][k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp >> 1) * 32 + (lane >> 3) * 4;
  const int n0 = (warp & 1) * 64 + (lane & 7) * 4;

  // loader coordinates (fixed over k)
  // row-major A: row a_m, k a_k + {0..3} and a_k + 8 + {0..3}
  const int a_m = tid >> 1, a_k = (tid & 1) * 4;
  // k-major A: k a_kk + 8i (i < 2), m a_mm .. a_mm + 3
  const int a_kk = tid >> 4, a_mm = (tid & 15) * 4;
  // row-major B: k b_k + 4i (i < 4), n b_n .. b_n + 3; transposed B: n tid
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  // the head of each column a thread scales (k-major A, row-major B)
  int hcol[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = (MODE == kStates ? m_base + a_mm : n_base + b_n) + j;
    hcol[j] = min(c / P, H - 1);
  }

  // the factors of row k for 4 columns, by their heads: one load when the
  // 4 columns share a head. Loaded with the values, applied at put(), so
  // no load is waited for before the current step's FMAs.
  const bool one_head = hcol[0] == hcol[3];
  auto factors = [&](float* f, int k) {
    const float* row = kscale + (long long)min(k, K - 1) * H;
    if (one_head) {
      f[0] = f[1] = f[2] = f[3] = row[hcol[0]];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = row[hcol[j]];
    }
  };

  float ra[8], rb[16], rs[MODE == kStates ? 8 : 1];
  auto fetch = [&](int k0) {
    if constexpr (MODE == kStates) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + a_kk + 8 * i, m = m_base + a_mm;
        const float* row = a + (long long)min(k, K - 1) * lda;
        if (k < K && m + 3 < M && (lda & 3) == 0) {
          const float4 v = *reinterpret_cast<const float4*>(row + m);
          ra[4 * i] = v.x; ra[4 * i + 1] = v.y;
          ra[4 * i + 2] = v.z; ra[4 * i + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ra[4 * i + j] = k < K && m + j < M ? row[m + j] : 0.f;
        }
        factors(rs + 4 * i, k);
      }
    } else {
      const int m = m_base + a_m;
      const float* row = a + (long long)min(m, M - 1) * lda;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + a_k + 8 * i;
        if (m < M && k + 3 < K && (lda & 3) == 0) {
          const float4 v = *reinterpret_cast<const float4*>(row + k);
          ra[4 * i] = v.x; ra[4 * i + 1] = v.y;
          ra[4 * i + 2] = v.z; ra[4 * i + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ra[4 * i + j] = m < M && k + j < K ? row[k + j] : 0.f;
        }
      }
    }
    if constexpr (MODE == kScores) {
      const int n = n_base + tid;
      const float* row = bsrc + (long long)min(n, Nn - 1) * ldb;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * i;
        if (n < Nn && k + 3 < K && (ldb & 3) == 0) {
          const float4 v = *reinterpret_cast<const float4*>(row + k);
          rb[4 * i] = v.x; rb[4 * i + 1] = v.y;
          rb[4 * i + 2] = v.z; rb[4 * i + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rb[4 * i + j] = n < Nn && k + j < K ? row[k + j] : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + b_k + 4 * i;
        const int n = n_base + b_n;
        const float* row = bsrc + (long long)min(k, K - 1) * ldb;
        if (k < K && n + 3 < Nn && (ldb & 3) == 0) {
          const float4 v = *reinterpret_cast<const float4*>(row + n);
          rb[4 * i] = v.x; rb[4 * i + 1] = v.y;
          rb[4 * i + 2] = v.z; rb[4 * i + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rb[4 * i + j] = k < K && n + j < Nn ? row[n + j] : 0.f;
        }
      }
    }
  };
  auto put = [&](int st) {
    if constexpr (MODE == kStates) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(&As[st][a_kk + 8 * i][a_mm]) = make_float4(
            ra[4 * i] * rs[4 * i], ra[4 * i + 1] * rs[4 * i + 1],
            ra[4 * i + 2] * rs[4 * i + 2], ra[4 * i + 3] * rs[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          As[st][a_k + 8 * i + j][a_m] = ra[4 * i + j];
    }
    if constexpr (MODE == kScores) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) Bs[st][k][tid] = rb[k];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&Bs[st][b_k + 4 * i][b_n]) = make_float4(
            rb[4 * i], rb[4 * i + 1], rb[4 * i + 2], rb[4 * i + 3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + kBK - 1) / kBK;
  if (nk > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch((kt + 1) * kBK);  // in flight during this step's FMAs
    float av[2][8], bv[2][8];
    auto operands = [&](int k, float* x, float* y) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][m0]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][m0 + 16]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][n0]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][n0 + 32]);
      x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
      x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
      y[0] = b0.x; y[1] = b0.y; y[2] = b0.z; y[3] = b0.w;
      y[4] = b1.x; y[5] = b1.y; y[6] = b1.z; y[7] = b1.w;
    };
    operands(0, av[0], bv[0]);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK) operands(k + 1, av[(k + 1) & 1], bv[(k + 1) & 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[k & 1][i], bv[k & 1][j], acc[i][j]);
    }
    if (more) put(cur ^ 1);
    __syncthreads();  // the next stage is written and this one read
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m_base + m0 + (i >> 2) * 16 + (i & 3);
    if (m >= M) continue;
    float* row = out + (long long)m * ldc;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = n_base + n0 + hh * 32;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][hh * 4 + j];
      if (n + 3 < Nn && (ldc & 3) == 0) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < Nn) row[n + j] = v[j];
      }
    }
  }
}

// ---- 2. scores G = C . B^T --------------------------------------------------

// Block i: chunk i / tiles, then its tiles, l tiles outer; tiles wholly
// above the diagonal return at once.
__global__ void __launch_bounds__(kGThreads, 4)
ssd_scores_kernel(const float* __restrict__ B, const float* __restrict__ C,
                  Work w, Dims d) {
  const int nt = (d.Q + kBN - 1) / kBN, mt = (d.Q + kBM - 1) / kBM;
  const long long b = blockIdx.x / (nt * mt);
  const int r = blockIdx.x % (nt * mt);
  const int m_base = r / nt * kBM, n_base = r % nt * kBN;
  if (n_base >= m_base + kBM) return;   // s > l everywhere in the tile
  const float* cb = C + b * d.Q * d.N;
  const float* bb = B + b * d.Q * d.N;
  gemm_tile<kScores>(cb, d.N, bb, d.N, w.G + b * d.Q * d.Qp, d.Qp, d.Q,
                     min(d.Q, d.Qp), d.N, m_base, n_base, nullptr, 1, 1);
}

// ---- 3. y: off the diagonal factored, the diagonal direct -------------------

// Columns of y are taken per head in slices of 64 (the last one of a head
// masked past P), two slices a block: warps 0 and 2 own the first, warps 1
// and 3 the second (a thread's 8 columns lie in one slice).
__device__ __forceinline__ int slice_head(int sl, const Dims& d) {
  return sl / d.PS;
}

// Block i: chunk i / (T * tiles), its l tile t (heaviest first) and a pair
// of column slices. The products run as the GEMM tile above (128 threads,
// a 64 x 128 tile, 8 x 8 a thread, 16-deep steps loaded a step ahead):
//   steps below l0 / 16: y += G[l, s] . (F[s, h] * x[s, h, p]) with A the
//     G rows (shared by both slices), then acc *= E[l, h];
//   the 4 diagonal steps: y += W_h[l, s] . (dt[s, h] * x[s, h, p]) with
//     W_h = G o exp(cs_l - cs_s) masked to s <= l, formed per head as the
//     step is loaded (one exponential per (l, s, head)); a warp skips the
//     steps wholly above its rows.
// Then y is stored once. A head whose flag is 0 has F = E = 0 here; its
// off-diagonal terms are added by ssd_direct_kernel.
__global__ void __launch_bounds__(kGThreads, 3)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             float* __restrict__ y, Work w, Dims d) {
  __shared__ __align__(16) float As[2][2][kBK][kAP];  // [stage][slice][k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int Q = d.Q, H = d.H, P = d.P;
  const int nt = (H * d.PS + 1) / 2;
  const long long b = blockIdx.x / (d.T * nt);
  const int r = blockIdx.x % (d.T * nt);
  const int t = d.T - 1 - r / nt, pair = r % nt;
  const int l0 = t * kT, rows = min(kT, Q - l0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp >> 1) * 32 + (lane >> 3) * 4;
  const int n0 = (warp & 1) * 64 + (lane & 7) * 4;
  const int nk1 = l0 / kBK, nk = nk1 + kT / kBK;

  // B loader: k b_k + 4i (i < 4), columns b_n .. b_n + 3 of the tile, all
  // in slice b_sl: head b_h, p b_p .. b_p + 3
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const int b_sl = 2 * pair + b_n / 64;
  const int b_h = slice_head(b_sl, d), b_p = b_sl % d.PS * 64 + b_n % 64;
  const bool b_in = b_h < H;
  // A loader, off the diagonal: row a_m, k a_k + {0..3}, a_k + 8 + {0..3}
  const int a_m = tid >> 1, a_k = (tid & 1) * 4;
  // A loader, diagonal: row d_m, k d_k .. d_k + 7, for both slices' heads
  const int d_m = tid & 63, d_k = (tid >> 6) * 8;
  int heads[2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    heads[q] = min(slice_head(2 * pair + q, d), H - 1);
  // cs of the diagonal tile's rows for both slices' heads
  __shared__ float csd[2][kT];
  {
    const int q = tid / kT, l = tid % kT;
    csd[q][l] = l < rows ? w.cs[(b * H + heads[q]) * Q + l0 + l] : 0.f;
  }
  __syncthreads();
  const float* G = w.G + b * Q * d.Qp;

  // raw loads of the next step (fetch); scaled, or turned into W, by put
  // after the current step's FMAs, so no load is waited for before them
  float ra[8], rb[16], rs[4];
  auto fetch = [&](int kt) {
    const bool diag = kt >= nk1;
    const int k0 = kt * kBK;   // s of the step's first row
    const int m = diag ? d_m : a_m;
    const float* row = G + (long long)(l0 + min(m, rows - 1)) * d.Qp + k0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          row + (diag ? d_k + 4 * i : a_k + 8 * i));
      ra[4 * i] = v.x; ra[4 * i + 1] = v.y;
      ra[4 * i + 2] = v.z; ra[4 * i + 3] = v.w;
    }
    // B: x, and its factor F (off the diagonal) or dt (diagonal) per row
    const float* f = diag ? dt + b * Q * H
                          : w.F + (b * d.T + t) * (long long)Q * H;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = k0 + b_k + 4 * i;
      const bool in = b_in && s < Q;
      const long long at = (b * Q + min(s, Q - 1)) * H + b_h;
      rs[i] = in ? f[(long long)s * H + b_h] : 0.f;
      if (in && (P & 3) == 0 && b_p + 3 < P) {
        const float4 v = *reinterpret_cast<const float4*>(x + at * P + b_p);
        rb[4 * i] = v.x; rb[4 * i + 1] = v.y;
        rb[4 * i + 2] = v.z; rb[4 * i + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[4 * i + e] = in && b_p + e < P ? x[at * P + b_p + e] : 0.f;
      }
    }
  };
  auto put = [&](int kt, int st) {
    if (kt < nk1) {
      const bool in = a_m < rows;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          As[st][0][a_k + 8 * i + e][a_m] = in ? ra[4 * i + e] : 0.f;
    } else {
      // W_h[l, s] = G[l, s] * exp(cs_l - cs_s), masked to s <= l < rows
      const int l = d_m, s0 = kt * kBK - l0 + d_k;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          As[st][q][d_k + e][d_m] =
              s0 + e <= l && l < rows
                  ? ra[e] * expf(csd[q][l] - csd[q][s0 + e])
                  : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&Bs[st][b_k + 4 * i][b_n]) = make_float4(
          rb[4 * i] * rs[i], rb[4 * i + 1] * rs[i], rb[4 * i + 2] * rs[i],
          rb[4 * i + 3] * rs[i]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  put(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch(kt + 1);  // in flight during this step's FMAs
    if (kt == nk1 && nk1 > 0) {
      // off the diagonal done: acc *= E[l, h]
      const int h = (warp & 1) ? heads[1] : heads[0];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int l = m0 + (i >> 2) * 16 + (i & 3);
        const float sc = w.E[(b * Q + l0 + min(l, rows - 1)) * H + h];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= sc;
      }
    }
    // a diagonal step wholly above this warp's rows adds nothing
    const bool skip = kt >= nk1 && (kt - nk1) * kBK > (warp >> 1) * 32 + 31;
    if (!skip) {
      const int q = kt < nk1 ? 0 : (warp & 1);
      float av[2][8], bv[2][8];
      auto operands = [&](int k, float* a, float* bb) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][q][k][m0]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[cur][q][k][m0 + 16]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][n0]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[cur][k][n0 + 32]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        bb[0] = b0.x; bb[1] = b0.y; bb[2] = b0.z; bb[3] = b0.w;
        bb[4] = b1.x; bb[5] = b1.y; bb[6] = b1.z; bb[7] = b1.w;
      };
      operands(0, av[0], bv[0]);
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        if (k + 1 < kBK) operands(k + 1, av[(k + 1) & 1], bv[(k + 1) & 1]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[k & 1][i], bv[k & 1][j], acc[i][j]);
      }
    }
    if (more) put(kt + 1, cur ^ 1);
    __syncthreads();  // the next stage is written and this one read
  }

  // store: a thread's columns are p0 + {0..3} and p0 + 32 + {0..3} of one
  // slice
  const int sl = 2 * pair + (warp & 1), h = slice_head(sl, d);
  if (h >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = m0 + (i >> 2) * 16 + (i & 3);
    if (l >= rows) continue;
    float* out = y + ((b * Q + l0 + l) * H + h) * P;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = sl % d.PS * 64 + (lane & 7) * 4 + hh * 32;
      if ((P & 3) == 0 && p + 3 < P) {
        *reinterpret_cast<float4*>(out + p) =
            make_float4(acc[i][hh * 4], acc[i][hh * 4 + 1],
                        acc[i][hh * 4 + 2], acc[i][hh * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p + j < P) out[p + j] = acc[i][hh * 4 + j];
      }
    }
  }
}

// ---- 4. heads whose cs increases: off the diagonal, direct -----------------

// Block i: chunk i / ((T - 1) * head groups), its l tile t >= 1 and a group
// of kDHeads heads; a block whose heads all have flag 1 returns at once.
// For each head with flag 0 and 64-wide slice of P: y[l0 + l, h, p] +=
// sum over s < l0 of W[l][s] (x * dt)[s][p], W = G o exp(cs_l - cs_s), one
// 64-row s tile at a time through shared memory; thread (ty, tx) owns rows
// ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3.
__global__ void __launch_bounds__(kDThreads)
ssd_direct_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  float* __restrict__ y, Work w, Dims d) {
  __shared__ __align__(16) float Wt[kT][kWP];   // W^T[s][l]
  __shared__ __align__(16) float Xs[kT][kWP];
  const int groups = (d.H + kDHeads - 1) / kDHeads;
  const long long b = blockIdx.x / ((d.T - 1) * groups);
  const int r = blockIdx.x % ((d.T - 1) * groups);
  const int t = 1 + r / groups, h0 = r % groups * kDHeads;
  const int l0 = t * kT;
  const int Q = d.Q, H = d.H, P = d.P;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rows = min(kT, Q - l0);
  for (int h = h0; h < min(H, h0 + kDHeads); ++h) {
    if (w.flag[b * H + h] != 0.f) continue;   // the same for the block
    const float* cs = w.cs + (b * H + h) * Q;
    for (int p0 = 0; p0 < P; p0 += kT) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s0 = 0; s0 < l0; s0 += kT) {
        __syncthreads();  // the previous tiles' readers are done
        // a warp reads 8 consecutive s of 4 rows l and stores them on 32
        // distinct banks
        for (int i = tid; i < kT * kT; i += kDThreads) {
          const int s = (i >> 9) * 8 + (i & 7), l = (i >> 3) & 63;
          Wt[s][l] = l < rows ? w.G[(b * Q + l0 + l) * d.Qp + s0 + s] *
                                    expf(cs[l0 + l] - cs[s0 + s])
                              : 0.f;
        }
        for (int i = tid; i < kT * kT; i += kDThreads) {
          const int s = i / kT, p = i % kT;
          const long long at = (b * Q + s0 + s) * H + h;
          Xs[s][p] = p0 + p < P ? x[at * P + p0 + p] * dt[at] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kT; ++k) {
          const float4 w0 = *reinterpret_cast<const float4*>(&Wt[k][ty * 8]);
          const float4 w1 =
              *reinterpret_cast<const float4*>(&Wt[k][ty * 8 + 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[k][tx * 4]);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
          const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(wv[i], xx[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int l = ty * 8 + i;
        if (l >= rows) continue;
        float* out = y + ((b * Q + l0 + l) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + tx * 4 + j;
          if (p < P) out[p] += acc[i][j];
        }
      }
    }
  }
}

// ---- 5. states --------------------------------------------------------------

// Block i: chunk i / tiles, then its tiles of [H*P x N].
__global__ void __launch_bounds__(kGThreads, 4)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ B,
                  float* __restrict__ states, Work w, Dims d) {
  const int nt = (d.N + kBN - 1) / kBN, mt = (d.HP + kBM - 1) / kBM;
  const long long b = blockIdx.x / (nt * mt);
  const int r = blockIdx.x % (nt * mt);
  gemm_tile<kStates>(x + b * d.Q * d.HP, d.HP, B + b * d.Q * d.N, d.N,
                     states + b * d.HP * d.N, d.N, d.HP, d.N, d.Q,
                     r / nt * kBM, r % nt * kBN, w.D + b * d.Q * d.H, d.H,
                     d.P);
}

bool fits_grid(long long blocks) { return blocks <= 0x7fffffffLL; }

}  // namespace

// Floats of workspace that ssd_chunk_f32 needs, into *out.
extern "C" int ssd_workspace_floats(int BC, int Q, int H, long long* out) {
  *out = workspace_floats(BC, Q, H);
  return 0;
}

// Launches the five kernels on `stream` and returns cudaGetLastError().
// x, y: [BC, Q, H, P]; dt: [BC, Q, H]; A: [H]; B, C: [BC, Q, N];
// states: [BC, H, P, N]; work: ssd_workspace_floats(BC, Q, H) floats; all
// contiguous float32.
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* A,
                             const float* B, const float* C, float* y,
                             float* states, float* work, int BC, int Q, int H,
                             int P, int N, cudaStream_t stream) {
  if (Q < 1 || P < 1 || N < 1 || H < 1 || BC < 0 ||
      (long long)H * P > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (BC == 0) return (int)cudaGetLastError();
  Dims d{BC, Q, H, P, N, (Q + kT - 1) / kT, 0, H * P, (P + kT - 1) / kT};
  d.Qp = d.T * kT;
  const Work w = carve(work, d);
  const long long bc = BC;
  const long long scores = bc * ((Q + kBN - 1) / kBN) * ((Q + kBM - 1) / kBM);
  const long long ys = bc * d.T * ((H * d.PS + 1) / 2);
  const long long direct = bc * (d.T - 1) * ((H + kDHeads - 1) / kDHeads);
  const long long st = bc * ((N + kBN - 1) / kBN) * ((d.HP + kBM - 1) / kBM);
  if (!fits_grid(scores) || !fits_grid(ys) || !fits_grid(direct) ||
      !fits_grid(st)) {
    return (int)cudaErrorInvalidValue;
  }
  ssd_scan_kernel<<<BC, kScanThreads, 0, stream>>>(dt, A, w, d);
  ssd_scores_kernel<<<(unsigned)scores, kGThreads, 0, stream>>>(B, C, w, d);
  ssd_y_kernel<<<(unsigned)ys, kGThreads, 0, stream>>>(x, dt, y, w, d);
  if (direct > 0) {
    ssd_direct_kernel<<<(unsigned)direct, kDThreads, 0, stream>>>(x, dt, y, w,
                                                                  d);
  }
  ssd_states_kernel<<<(unsigned)st, kGThreads, 0, stream>>>(x, B, states, w, d);
  return (int)cudaGetLastError();
}
