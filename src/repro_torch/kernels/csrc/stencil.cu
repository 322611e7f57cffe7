// Hand-written Hopper kernels for the 7-point DIA stencil of the SIMPLE
// solver (K1-K3).  Built by nvcc for sm_90a into a shared library with a
// plain C interface (repro_torch/kernels/build.py) and called through
// ctypes (repro_torch/kernels/stencil_spmv/kernel.py).
//
// Replaces (JAX package, src/repro/kernels/stencil_spmv/kernel.py):
//   K1 stencil_spmv      (_kernel)           y = diag*x + sum_f off[f]*x[nb_f]
//   K2 rb_dilu_forward   (_rb_kernel)        forward half-sweep of RB-DILU
//   K3 rb_dilu_backward  (_rb_back_kernel)   backward half-sweep of RB-DILU
//
// What bounds them on an H100: bytes.  Per cell K1 moves 36 B (diag, six
// off bands, x, y in f32) for 13 flops; K2/K3 move 37 B (rdiag, six off
// bands, r or y, the result in f32, red in 1 B).  That is ~0.4 flop/B,
// two orders of magnitude under the card's ridge point, so the design
// goal is one pass over HBM with coalesced loads and nothing else.
//
// Design:
// * One thread per cell; (i,j,k) from the flat row-major index, so a warp
//   reads 32 consecutive cells of every band (coalesced).
// * Each neighbour is guarded by its 3-D bound and skipped outside the
//   domain.  The TPU kernel instead read x through a flat stride with a
//   padded copy of x (three padded arrays per call) and relied on
//   off[f] == 0 at the walls to cancel the wrapped neighbour; here nothing
//   is read out of range, no padded copy is made, and a NaN*0 from a
//   wrapped neighbour cannot occur.
// * Neighbour reads of x (K1), red*r*rdiag (K2) and black*y (K3) hit the
//   same lines as the centre reads of nearby threads and are served by
//   L1/L2; K2 recomputes red*r*rdiag per neighbour from global memory
//   instead of staging a window in shared memory.
// * Sums run in the reference's order (diag*x first, then faces
//   -x,+x,-y,+y,-z,+z) with explicitly rounded multiply and add
//   (__fmul_rn/__fadd_rn: no FMA contraction), so each cell reproduces the
//   PyTorch plain version (ref.py) operation for operation.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Cell {
  long long c;      // flat index
  int i, j, k;      // 3-D index
};

__device__ __forceinline__ bool cell_of(int nx, int ny, int nz, Cell* out) {
  const long long n = (long long)nx * ny * nz;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return false;
  out->c = c;
  out->k = (int)(c % nz);
  const long long t = c / nz;
  out->j = (int)(t % ny);
  out->i = (int)(t / ny);
  return true;
}

// neighbour-guarded face sum: acc += off[f]*v(nb_f) in face order
// -x,+x,-y,+y,-z,+z, with v a device functor of the neighbour's index.
template <typename V>
__device__ __forceinline__ float face_sum(float acc, const float* __restrict__ off,
                                          const Cell& p, int nx, int ny, int nz,
                                          V v) {
  const long long n = (long long)nx * ny * nz;
  const long long sx = (long long)ny * nz, sy = nz;
  const long long c = p.c;
  if (p.i > 0)      acc = __fadd_rn(acc, __fmul_rn(off[0 * n + c], v(c - sx)));
  if (p.i < nx - 1) acc = __fadd_rn(acc, __fmul_rn(off[1 * n + c], v(c + sx)));
  if (p.j > 0)      acc = __fadd_rn(acc, __fmul_rn(off[2 * n + c], v(c - sy)));
  if (p.j < ny - 1) acc = __fadd_rn(acc, __fmul_rn(off[3 * n + c], v(c + sy)));
  if (p.k > 0)      acc = __fadd_rn(acc, __fmul_rn(off[4 * n + c], v(c - 1)));
  if (p.k < nz - 1) acc = __fadd_rn(acc, __fmul_rn(off[5 * n + c], v(c + 1)));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
stencil_spmv_kernel(const float* __restrict__ diag, const float* __restrict__ off,
                    const float* __restrict__ x, float* __restrict__ y,
                    int nx, int ny, int nz) {
  Cell p;
  if (!cell_of(nx, ny, nz, &p)) return;
  const float acc = __fmul_rn(diag[p.c], x[p.c]);
  y[p.c] = face_sum(acc, off, p, nx, ny, nz,
                    [x](long long q) { return x[q]; });
}

// w = red ? r*rdiag : (r - sum_f off[f]*(red*r*rdiag)[nb_f]) * rdiag
__global__ void __launch_bounds__(kThreads)
rb_dilu_forward_kernel(const float* __restrict__ rdiag,
                       const uint8_t* __restrict__ red,
                       const float* __restrict__ off,
                       const float* __restrict__ r, float* __restrict__ w,
                       int nx, int ny, int nz) {
  Cell p;
  if (!cell_of(nx, ny, nz, &p)) return;
  const long long c = p.c;
  if (red[c]) {
    w[c] = __fmul_rn(r[c], rdiag[c]);
    return;
  }
  const float acc = face_sum(0.0f, off, p, nx, ny, nz, [=](long long q) {
    return red[q] ? __fmul_rn(r[q], rdiag[q]) : 0.0f;
  });
  w[c] = __fmul_rn(__fsub_rn(r[c], acc), rdiag[c]);
}

// z = red ? y - rdiag * sum_f off[f]*(black*y)[nb_f] : y
__global__ void __launch_bounds__(kThreads)
rb_dilu_backward_kernel(const float* __restrict__ rdiag,
                        const uint8_t* __restrict__ red,
                        const float* __restrict__ off,
                        const float* __restrict__ y, float* __restrict__ z,
                        int nx, int ny, int nz) {
  Cell p;
  if (!cell_of(nx, ny, nz, &p)) return;
  const long long c = p.c;
  if (!red[c]) {
    z[c] = y[c];
    return;
  }
  const float acc = face_sum(0.0f, off, p, nx, ny, nz, [=](long long q) {
    return red[q] ? 0.0f : y[q];
  });
  z[c] = __fsub_rn(y[c], __fmul_rn(rdiag[c], acc));
}

inline unsigned blocks_for(int nx, int ny, int nz) {
  const long long n = (long long)nx * ny * nz;
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// C interface: every entry launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched).
extern "C" {

int stencil_spmv_f32(const float* diag, const float* off, const float* x,
                     float* y, int nx, int ny, int nz, cudaStream_t stream) {
  const unsigned blocks = blocks_for(nx, ny, nz);
  if (blocks) {
    stencil_spmv_kernel<<<blocks, kThreads, 0, stream>>>(diag, off, x, y,
                                                          nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

int rb_dilu_forward_f32(const float* rdiag, const uint8_t* red,
                        const float* off, const float* r, float* w,
                        int nx, int ny, int nz, cudaStream_t stream) {
  const unsigned blocks = blocks_for(nx, ny, nz);
  if (blocks) {
    rb_dilu_forward_kernel<<<blocks, kThreads, 0, stream>>>(rdiag, red, off,
                                                             r, w, nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

int rb_dilu_backward_f32(const float* rdiag, const uint8_t* red,
                         const float* off, const float* y, float* z,
                         int nx, int ny, int nz, cudaStream_t stream) {
  const unsigned blocks = blocks_for(nx, ny, nz);
  if (blocks) {
    rb_dilu_backward_kernel<<<blocks, kThreads, 0, stream>>>(rdiag, red, off,
                                                              y, z, nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
