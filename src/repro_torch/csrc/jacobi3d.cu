// 7-point Jacobi sweep for Hopper (sm_90a), float32, bfloat16 and float16.
//
// Replaces the Pallas TPU kernel `_jacobi_kernel` / `jacobi3d` in
// src/repro/kernels/jacobi3d.py. Two entry points per type share one
// stencil:
//
//   jacobi3d_<t>        the Pallas contract: halo-padded slab
//                       u_pad [X+2, Y+2, Z+2] in, interior [X, Y, Z] out;
//   jacobi3d_faces_<t>  stencil_update's contract (src/repro/apps/
//                       jacobi3d.py): chunk u [X, Y, Z] plus its six face
//                       halos; a point on the chunk boundary reads its
//                       neighbour from the face array, so the padded copy
//                       of the chunk is never built.
//
// with <t> one of f32, bf16, f16; the output has the input's type.
//
// Numerics: the six neighbours are summed in the reference's fixed order
// (x-1, x+1, y-1, y+1, z-1, z+1), each add done in float and rounded to
// float (__fadd_rn) and then to the element type, then divided by 6 with
// an IEEE division (__fdiv_rn; never a multiply by 1/6) and rounded to the
// element type. That is what PyTorch's elementwise add and true division
// compute for these types (in float, rounded back after each operation),
// so the result equals the plain PyTorch version bit for bit. Built
// without --use_fast_math.
//
// Bound on an H100 SXM: memory. Each output point needs 6 adds and one
// divide, but 2 x sizeof(element) bytes of device traffic (read u once,
// write out once), so the least time is 8*X*Y*Z bytes / 3.35 TB/s in
// float32: 0.135 ms for one 384^3 chunk.
//
// jacobi3d_faces (the proxy's path) marches along x. Each thread owns one
// (y, z) column over a segment of x planes, short enough that the grid
// fills the SMs many times (at 384^3: 12 x 48 blocks of 32 x 8 threads x
// 8 segments of 48 planes). It keeps its column's x-1 and x values in
// registers and loads each plane kPF steps ahead of its use, so the x
// neighbours, a plane (590 KB) apart, leave device memory once instead of
// coming back from L2 as they did in the first design (one thread a point,
// six loads each: 0.284 ms at 384^3 on an H100 SXM at 700 W). The y and z
// neighbours of plane x are loaded where they are used; the neighbouring
// threads load the same points as their own columns, so they come from L1
// or L2, not device memory. The four loads a point that leave the SM that
// way are the likely limit (about half the bound; not measured apart from
// the rest). Two other designs were slower in every form tried on the
// card: a plane tile with its halo staged in shared memory (one barrier a
// plane), and four rows a thread in registers with the z neighbours by
// warp shuffle.
//
// jacobi3d (padded, on no main path) keeps the first design: one thread a
// point with z fastest, the six neighbour loads overlapping in L1 and L2.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename E>
__device__ __forceinline__ E from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to E and back: each step of the sum as PyTorch rounds it
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<E>(x));
}

template <typename E>
__device__ __forceinline__ E sweep(float xm, float xp, float ym, float yp,
                                   float zm, float zp) {
  float s = round_to<E>(__fadd_rn(xm, xp));
  s = round_to<E>(__fadd_rn(s, ym));
  s = round_to<E>(__fadd_rn(s, yp));
  s = round_to<E>(__fadd_rn(s, zm));
  s = round_to<E>(__fadd_rn(s, zp));
  return from_float<E>(__fdiv_rn(s, 6.0f));
}

// ---- padded entry: one thread a point --------------------------------------

constexpr int kBZ = 32;   // threads along z (one warp: coalesced rows)
constexpr int kBY = 8;    // threads along y

template <typename E>
__global__ void jacobi3d_pad_kernel(const E* __restrict__ up,
                                    E* __restrict__ out, int X, int Y,
                                    int Z) {
  const int z = blockIdx.x * kBZ + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  const long long sy = Z + 2;
  const long long sx = (long long)(Y + 2) * (Z + 2);
  const long long c = (x + 1) * sx + (y + 1) * sy + (z + 1);
  out[((long long)x * Y + y) * Z + z] = sweep<E>(
      to_float(up[c - sx]), to_float(up[c + sx]), to_float(up[c - sy]),
      to_float(up[c + sy]), to_float(up[c - 1]), to_float(up[c + 1]));
}

// ---- faces entry: x-marching columns ---------------------------------------

constexpr int kMZ = 32;   // threads along z (one warp: coalesced rows)
constexpr int kMY = 8;    // threads along y
constexpr int kWaveBlocks = 132 * 32;     // blocks the grid aims for
constexpr int kPF = 4;    // planes loaded ahead of their use

// Thread (z, y) marches along x over planes [x0, x1) of its column,
// keeping x-1 and x in registers and x+1 .. x+kPF in flight; the y and z
// neighbours of plane x are loaded where they are used (the columns of the
// neighbouring threads, which load them too). No shared memory, no
// barrier.
template <typename E>
__global__ void __launch_bounds__(kMZ * kMY)
jacobi3d_faces_kernel(const E* __restrict__ u, const E* __restrict__ lo0,
                      const E* __restrict__ hi0, const E* __restrict__ lo1,
                      const E* __restrict__ hi1, const E* __restrict__ lo2,
                      const E* __restrict__ hi2, E* __restrict__ out, int X,
                      int Y, int Z, int seg) {
  const int z = blockIdx.x * kMZ + threadIdx.x;
  const int y = blockIdx.y * kMY + threadIdx.y;
  const int x0 = blockIdx.z * seg, x1 = min(X, x0 + seg);
  if (z >= Z || y >= Y) return;
  const long long plane = (long long)Y * Z, yz = (long long)y * Z + z;
  // this column at plane x, the faces lo0 / hi0 past the chunk
  auto column = [&](int x) {
    return to_float(x < 0 ? lo0[yz] : x >= X ? hi0[yz] : u[x * plane + yz]);
  };
  // xm, c: planes x - 1 and x; ring[j]: plane p at j = (p - x0) % kPF for
  // p in x + 1 .. x + kPF, loaded kPF steps ahead of its use. Steps run in
  // groups of kPF with the slot known at compile time, so no value moves
  // between registers while its load is in flight.
  float xm = column(x0 - 1), c = column(x0), ring[kPF];
#pragma unroll
  for (int i = 1; i <= kPF; ++i)
    ring[i % kPF] = x0 + i <= X ? column(x0 + i) : 0.f;
  for (int xb = x0; xb < x1; xb += kPF) {
#pragma unroll
    for (int j = 0; j < kPF; ++j) {
      const int x = xb + j;
      if (x >= x1) break;
      const int nxt = (j + 1) % kPF;
      const float xp = ring[nxt];
      ring[nxt] = x + 1 + kPF <= X ? column(x + 1 + kPF) : 0.f;
      const E* at = u + x * plane + yz;
      const float ym = to_float(y > 0 ? at[-Z] : lo1[(long long)x * Z + z]);
      const float yp =
          to_float(y < Y - 1 ? at[Z] : hi1[(long long)x * Z + z]);
      const float zm = to_float(z > 0 ? at[-1] : lo2[(long long)x * Y + y]);
      const float zp =
          to_float(z < Z - 1 ? at[1] : hi2[(long long)x * Y + y]);
      out[x * plane + yz] = sweep<E>(xm, xp, ym, yp, zm, zp);
      xm = c;
      c = xp;
    }
  }
}

dim3 grid_for(int X, int Y, int Z) {
  return dim3((Z + kBZ - 1) / kBZ, (Y + kBY - 1) / kBY, X);
}

template <typename E>
int launch_pad(const E* u_pad, E* out, int X, int Y, int Z,
               cudaStream_t stream) {
  if (X > 0 && Y > 0 && Z > 0) {
    jacobi3d_pad_kernel<E><<<grid_for(X, Y, Z), dim3(kBZ, kBY), 0, stream>>>(
        u_pad, out, X, Y, Z);
  }
  return (int)cudaGetLastError();
}

template <typename E>
int launch_faces(const E* u, const E* lo0, const E* hi0, const E* lo1,
                 const E* hi1, const E* lo2, const E* hi2, E* out, int X,
                 int Y, int Z, cudaStream_t stream) {
  if (X > 0 && Y > 0 && Z > 0) {
    const int tiles = ((Z + kMZ - 1) / kMZ) * ((Y + kMY - 1) / kMY);
    const int segs = max(1, min(X, (kWaveBlocks + tiles - 1) / tiles));
    const int seg = (X + segs - 1) / segs;
    const dim3 grid((Z + kMZ - 1) / kMZ, (Y + kMY - 1) / kMY,
                    (X + seg - 1) / seg);
    jacobi3d_faces_kernel<E><<<grid, dim3(kMZ, kMY), 0, stream>>>(
        u, lo0, hi0, lo1, hi1, lo2, hi2, out, X, Y, Z, seg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// X, Y, Z are the interior (output) extents; all arrays are contiguous and
// of one type.

extern "C" int jacobi3d_f32(const float* u_pad, float* out, int X, int Y,
                            int Z, cudaStream_t stream) {
  return launch_pad(u_pad, out, X, Y, Z, stream);
}

extern "C" int jacobi3d_bf16(const __nv_bfloat16* u_pad, __nv_bfloat16* out,
                             int X, int Y, int Z, cudaStream_t stream) {
  return launch_pad(u_pad, out, X, Y, Z, stream);
}

extern "C" int jacobi3d_f16(const __half* u_pad, __half* out, int X, int Y,
                            int Z, cudaStream_t stream) {
  return launch_pad(u_pad, out, X, Y, Z, stream);
}

extern "C" int jacobi3d_faces_f32(const float* u, const float* lo0,
                                  const float* hi0, const float* lo1,
                                  const float* hi1, const float* lo2,
                                  const float* hi2, float* out, int X, int Y,
                                  int Z, cudaStream_t stream) {
  return launch_faces(u, lo0, hi0, lo1, hi1, lo2, hi2, out, X, Y, Z, stream);
}

extern "C" int jacobi3d_faces_bf16(const __nv_bfloat16* u,
                                   const __nv_bfloat16* lo0,
                                   const __nv_bfloat16* hi0,
                                   const __nv_bfloat16* lo1,
                                   const __nv_bfloat16* hi1,
                                   const __nv_bfloat16* lo2,
                                   const __nv_bfloat16* hi2,
                                   __nv_bfloat16* out, int X, int Y, int Z,
                                   cudaStream_t stream) {
  return launch_faces(u, lo0, hi0, lo1, hi1, lo2, hi2, out, X, Y, Z, stream);
}

extern "C" int jacobi3d_faces_f16(const __half* u, const __half* lo0,
                                  const __half* hi0, const __half* lo1,
                                  const __half* hi1, const __half* lo2,
                                  const __half* hi2, __half* out, int X,
                                  int Y, int Z, cudaStream_t stream) {
  return launch_faces(u, lo0, hi0, lo1, hi1, lo2, hi2, out, X, Y, Z, stream);
}
