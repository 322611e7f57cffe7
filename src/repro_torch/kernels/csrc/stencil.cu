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
// bands, r or y, the result in f32, red in 1 B).  K2 uses only the black
// cells' off values and K3 only the red cells', but the colours alternate
// at a 4-B stride along k, so every 32-B sector of a band holds both and
// the card reads every band whole: 37 B it is.  That is ~0.4 flop/B, two
// orders of magnitude under the card's ridge point, so the design goal is
// one pass over HBM with coalesced loads and nothing else.
//
// Design:
// * K1: one thread per cell; (i,j,k) from the flat row-major index, so a
//   warp reads 32 consecutive cells of every band (coalesced).
// * K2/K3: one thread per k-adjacent pair of cells of a row (the row's
//   last cell has no partner when nz is odd).  Under the checkerboard
//   exactly one cell of a pair is swept (K2: black, K3: red), so every
//   lane runs one face sum; with one thread per cell and a branch on the
//   colour, half the lanes of every warp idled through it.  The colour is
//   read from `red`, never from the parity of i+j+k: a pair with two
//   swept cells (any other mask) takes a second face sum.
// * Each neighbour is guarded by its 3-D bound and skipped outside the
//   domain.  The TPU kernel instead read x through a flat stride with a
//   padded copy of x (three padded arrays per call) and relied on
//   off[f] == 0 at the walls to cancel the wrapped neighbour; here nothing
//   is read out of range, no padded copy is made, and a NaN*0 from a
//   wrapped neighbour cannot occur.
// * Neighbour values (x for K1, red*r*rdiag for K2, black*y for K3) are
//   read at each face, all loads issued at once (none waits on red), and
//   hit the lines of nearby threads' centre reads in L1/L2.  Computing
//   each value once into a shared-memory window (2.5-D blocking along i,
//   with or without a cp.async prefetch of the next plane) measured no
//   faster on the H100, so the kernels do not (PERF.md, section 6).
// * Sums run in the reference's order (diag*x first for K1, then faces
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

// K2 (kForward) and K3 in one body.  A half-sweep updates its "swept"
// cells (K2: black, K3: red) from the neighbour field v (K2: red ? r*rdiag
// : 0; K3: red ? 0 : y) and passes the others through (K2: r*rdiag, K3:
// y).  One thread takes a k-adjacent pair of cells.
template <bool kForward>
__device__ __forceinline__ bool swept(bool is_red) {
  return kForward ? !is_red : is_red;
}

template <bool kForward>
__device__ __forceinline__ float pass_value(float x, float rd) {
  return kForward ? __fmul_rn(x, rd) : x;
}

template <bool kForward>
__device__ __forceinline__ float sweep_value(float x, float rd, float acc) {
  return kForward ? __fmul_rn(__fsub_rn(x, acc), rd)
                  : __fsub_rn(x, __fmul_rn(rd, acc));
}

template <bool kForward>
__global__ void __launch_bounds__(kThreads)
rb_dilu_pair_kernel(const float* __restrict__ rdiag,
                    const uint8_t* __restrict__ red,
                    const float* __restrict__ off,
                    const float* __restrict__ x, float* __restrict__ out,
                    int nx, int ny, int nz) {
  const int pairs = (nz + 1) / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nx * ny * pairs) return;
  const long long row = t / pairs;
  Cell a;
  a.k = 2 * (int)(t % pairs);
  a.j = (int)(row % ny);
  a.i = (int)(row / ny);
  a.c = row * nz + a.k;
  const bool has1 = a.k + 1 < nz;
  const bool s0 = swept<kForward>(red[a.c] != 0);
  const bool s1 = has1 && swept<kForward>(red[a.c + 1] != 0);
  auto v = [=](long long q) {        // all loads at once: none waits on red
    const float xq = x[q], rdq = kForward ? rdiag[q] : 0.0f;
    const bool rq = red[q] != 0;
    return kForward ? (rq ? __fmul_rn(xq, rdq) : 0.0f) : (rq ? 0.0f : xq);
  };
  // the face sum of the pair's first swept cell: one per lane
  Cell b = a;
  if (!s0) { b.k += 1; b.c += 1; }
  float acc_b = 0.0f, acc_1 = 0.0f;
  if (s0 || s1) acc_b = face_sum(0.0f, off, b, nx, ny, nz, v);
  if (s0 && s1) {                        // two swept cells: not a checkerboard
    Cell c1 = a;
    c1.k += 1;
    c1.c += 1;
    acc_1 = face_sum(0.0f, off, c1, nx, ny, nz, v);
  }
  out[a.c] = s0 ? sweep_value<kForward>(x[a.c], rdiag[a.c], acc_b)
                : pass_value<kForward>(x[a.c], rdiag[a.c]);
  if (has1) {
    const long long c = a.c + 1;
    out[c] = s1 ? sweep_value<kForward>(x[c], rdiag[c], s0 ? acc_1 : acc_b)
                : pass_value<kForward>(x[c], rdiag[c]);
  }
}

inline unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// C interface: every entry launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched).
extern "C" {

int stencil_spmv_f32(const float* diag, const float* off, const float* x,
                     float* y, int nx, int ny, int nz, cudaStream_t stream) {
  const unsigned blocks = blocks_for((long long)nx * ny * nz);
  if (blocks) {
    stencil_spmv_kernel<<<blocks, kThreads, 0, stream>>>(diag, off, x, y,
                                                          nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

int rb_dilu_forward_f32(const float* rdiag, const uint8_t* red,
                        const float* off, const float* r, float* w,
                        int nx, int ny, int nz, cudaStream_t stream) {
  const unsigned blocks = blocks_for((long long)nx * ny * ((nz + 1) / 2));
  if (blocks) {
    rb_dilu_pair_kernel<true><<<blocks, kThreads, 0, stream>>>(
        rdiag, red, off, r, w, nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

int rb_dilu_backward_f32(const float* rdiag, const uint8_t* red,
                         const float* off, const float* y, float* z,
                         int nx, int ny, int nz, cudaStream_t stream) {
  const unsigned blocks = blocks_for((long long)nx * ny * ((nz + 1) / 2));
  if (blocks) {
    rb_dilu_pair_kernel<false><<<blocks, kThreads, 0, stream>>>(
        rdiag, red, off, y, z, nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
