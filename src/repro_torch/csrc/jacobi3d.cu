// 7-point Jacobi sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_jacobi_kernel` / `jacobi3d` in
// src/repro/kernels/jacobi3d.py. Two entry points share one stencil:
//
//   jacobi3d_f32        the Pallas contract: halo-padded slab
//                       u_pad [X+2, Y+2, Z+2] in, interior [X, Y, Z] out;
//   jacobi3d_faces_f32  stencil_update's contract (src/repro/apps/
//                       jacobi3d.py): chunk u [X, Y, Z] plus its six face
//                       halos; a point on the chunk boundary reads its
//                       neighbour from the face array, so the padded copy
//                       of the chunk is never built.
//
// Numerics: the six neighbours are summed in the reference's fixed order
// (x-1, x+1, y-1, y+1, z-1, z+1), each add rounded to float, then divided
// by 6 with an IEEE division (__fdiv_rn; never a multiply by 1/6). Built
// without --use_fast_math. The result equals the plain PyTorch version bit
// for bit.
//
// Bound on an H100 SXM: memory. Each output point needs 6 adds and one
// divide, but 8 bytes of device traffic (read u once, write out once), so
// the least time is 8*X*Y*Z bytes / 3.35 TB/s: 0.135 ms for one 384^3
// chunk, 1.08 ms for a whole 768^3 sweep. This first design gives each
// thread one output point with z fastest, so a warp reads and writes 128
// contiguous bytes per row; the six neighbour loads of a block overlap in
// L1/L2, and nothing is staged in shared memory. Marching along x over
// (y, z) plane tiles, so that each plane is loaded from device memory once,
// is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBZ = 32;   // threads along z (one warp: coalesced rows)
constexpr int kBY = 8;    // threads along y

__device__ __forceinline__ float sweep(float xm, float xp, float ym,
                                       float yp, float zm, float zp) {
  float s = __fadd_rn(xm, xp);
  s = __fadd_rn(s, ym);
  s = __fadd_rn(s, yp);
  s = __fadd_rn(s, zm);
  s = __fadd_rn(s, zp);
  return __fdiv_rn(s, 6.0f);
}

__global__ void jacobi3d_pad_kernel(const float* __restrict__ up,
                                    float* __restrict__ out, int X, int Y,
                                    int Z) {
  const int z = blockIdx.x * kBZ + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  const long long sy = Z + 2;
  const long long sx = (long long)(Y + 2) * (Z + 2);
  const long long c = (x + 1) * sx + (y + 1) * sy + (z + 1);
  out[((long long)x * Y + y) * Z + z] =
      sweep(up[c - sx], up[c + sx], up[c - sy], up[c + sy], up[c - 1],
            up[c + 1]);
}

__global__ void jacobi3d_faces_kernel(
    const float* __restrict__ u, const float* __restrict__ lo0,
    const float* __restrict__ hi0, const float* __restrict__ lo1,
    const float* __restrict__ hi1, const float* __restrict__ lo2,
    const float* __restrict__ hi2, float* __restrict__ out, int X, int Y,
    int Z) {
  const int z = blockIdx.x * kBZ + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  const long long sx = (long long)Y * Z;
  const long long c = x * sx + (long long)y * Z + z;
  // face layouts: lo0/hi0 [Y, Z], lo1/hi1 [X, Z], lo2/hi2 [X, Y]
  const float xm = x > 0 ? u[c - sx] : lo0[(long long)y * Z + z];
  const float xp = x < X - 1 ? u[c + sx] : hi0[(long long)y * Z + z];
  const float ym = y > 0 ? u[c - Z] : lo1[(long long)x * Z + z];
  const float yp = y < Y - 1 ? u[c + Z] : hi1[(long long)x * Z + z];
  const float zm = z > 0 ? u[c - 1] : lo2[(long long)x * Y + y];
  const float zp = z < Z - 1 ? u[c + 1] : hi2[(long long)x * Y + y];
  out[c] = sweep(xm, xp, ym, yp, zm, zp);
}

dim3 grid_for(int X, int Y, int Z) {
  return dim3((Z + kBZ - 1) / kBZ, (Y + kBY - 1) / kBY, X);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// X, Y, Z are the interior (output) extents; all arrays are contiguous.

extern "C" int jacobi3d_f32(const float* u_pad, float* out, int X, int Y,
                            int Z, cudaStream_t stream) {
  if (X > 0 && Y > 0 && Z > 0) {
    jacobi3d_pad_kernel<<<grid_for(X, Y, Z), dim3(kBZ, kBY), 0, stream>>>(
        u_pad, out, X, Y, Z);
  }
  return (int)cudaGetLastError();
}

extern "C" int jacobi3d_faces_f32(const float* u, const float* lo0,
                                  const float* hi0, const float* lo1,
                                  const float* hi1, const float* lo2,
                                  const float* hi2, float* out, int X, int Y,
                                  int Z, cudaStream_t stream) {
  if (X > 0 && Y > 0 && Z > 0) {
    jacobi3d_faces_kernel<<<grid_for(X, Y, Z), dim3(kBZ, kBY), 0, stream>>>(
        u, lo0, hi0, lo1, hi1, lo2, hi2, out, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
