// Hand-written Hopper kernel for the RWKV6 time-mix scan (K5).  Built by
// nvcc for sm_90a into the port's shared library with a plain C interface
// (repro_torch/kernels/build.py) and called through ctypes
// (repro_torch/kernels/rwkv6_scan/kernel.py).
//
// Replaces (JAX package): src/repro/kernels/rwkv6_scan/kernel.py:71
// `rwkv6_scan` (body `_kernel` :28), the chunked linear-attention scan.
// Per (batch, head), for chunks of kC tokens, with la = running sum of
// log w over the chunk and la_prev = la - log w:
//   inter[t,:] = (r[t] * exp(la_prev[t])) @ S
//   att[t,i]   = sum_d r[t,d] k[i,d] exp(la_prev[t,d] - la[i,d])   (i < t)
//   att[t,t]   = sum_d r[t,d] u[d] k[t,d]
//   out        = inter + att @ v
//   S         <- exp(la_C)[:,None] * S + (k * exp(la_C - la))^T @ v
//
// Differences from the TPU kernel, by design:
// * The state starts from S_in (the caller's state), not from zero, so the
//   superposition pass the reference adds after its kernel (a second
//   [B,T,H,hd] x [hd,hd] product plus a running decay sum over all of T,
//   src/repro/models/rwkv6.py:171-184) is not needed.
// * The TPU grid's sequential chunk axis is a loop inside the block; the
//   [hd,hd] f32 state lives in shared memory for the whole loop and is
//   written to S_out once.
// * The [C,C,hd] pairwise-decay tensor of the Pallas body (1 MB at
//   C = hd = 64) is never built: each (t,i) pair loops over d and only
//   att [C,C] is kept.  Exponents are formed only for i < t, where
//   la_prev[t] - la[i] <= 0 exactly (a running sum of non-positive terms
//   never increases in floating point), so a steep decay underflows to 0
//   and never becomes inf * 0 = NaN.
// * Decays are kept in log2 units and exponentiated with exp2f.
// * The chunk inside the kernel is kC = 64 and T need not be a multiple of
//   it: rows past T load as r = k = v = log w = 0 and are not stored.  The
//   chunk length does not change the result.
//
// What bounds it on an H100: operations.  At B=4, T=1024, H=64, hd=64 with
// bf16 r/k/v it moves ~243 MB (0.073 ms at 3.35 TB/s) and does ~8 G
// operations counting each exp as one (0.12 ms at 67 TFLOP/s f32).  This
// first version is plain f32 CUDA cores, no tensor cores: each thread owns
// a 4x4 register tile in every phase, so one shared-memory load feeds
// about two multiply-adds, and the causal half of att is skipped tile by
// tile.  wgmma/TMA are later work.
//
// Shared memory per block, in floats, rows padded to 65 so that a warp
// reading one column of 32 rows hits 32 banks:
//   S [64][65], r [64][65] (then r*exp(la_prev)), k [64][65] (then k*exp(
//   la_C - la)), v [64][65], la [65][65] (row 0 = 0, row t+1 = la[t], so
//   row t = la_prev[t]), att [64][65], u [64]
// = 100,356 bytes: dynamic shared memory above the 48 KB default, two
// blocks per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHD = 64;          // largest head dim the kernel takes
constexpr int kC = 64;           // chunk length inside the kernel
constexpr int kP = kHD + 1;      // padded row stride of the [*, hd] tiles
constexpr int kThreads = 256;    // 16 x 16 threads, one 4x4 tile each
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmemFloats = 5 * kC * kP + (kC + 1) * kP + kHD;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ s_in,
                  float* __restrict__ out, float* __restrict__ s_out,
                  int T_len, int H, int hd) {
  extern __shared__ float smem[];
  float* sS = smem;                  // [kHD][kP]
  float* sr = sS + kHD * kP;         // [kC][kP]
  float* sk = sr + kC * kP;          // [kC][kP]
  float* sv = sk + kC * kP;          // [kC][kP]
  float* att = sv + kC * kP;         // [kC][kP]
  float* sla = att + kC * kP;        // [kC + 1][kP]
  float* su = sla + (kC + 1) * kP;   // [kHD]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;         // b * H + h
  const int b = bh / H, h = bh % H;
  const long long row = (long long)H * hd;             // t -> t+1
  const long long base = (long long)b * T_len * row + (long long)h * hd;
  const int ty = tid / 16, tx = tid % 16;              // tile coordinates

  const float* sin_bh = s_in + (long long)bh * hd * hd;
  for (int e = tid; e < kHD * kHD; e += kThreads) {
    const int d = e / kHD, j = e % kHD;
    sS[d * kP + j] = (d < hd && j < hd) ? sin_bh[d * hd + j] : 0.0f;
  }
  for (int d = tid; d < kHD; d += kThreads) {
    su[d] = d < hd ? u[h * hd + d] : 0.0f;
    sla[d] = 0.0f;                   // row 0: la_prev of the first token
  }

  for (int t0 = 0; t0 < T_len; t0 += kC) {
    const int L = min(kC, T_len - t0);
    __syncthreads();     // the last chunk's readers of r/k/v/la are done

    // 1. load the chunk as f32, log w in log2 units; rows >= L are zero
    for (int e = tid; e < kC * kHD; e += kThreads) {
      const int t = e / kHD, d = e % kHD;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, lw = 0.0f;
      if (t < L && d < hd) {
        const long long g = base + (long long)(t0 + t) * row + d;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
        lw = logw[g] * kLog2e;
      }
      sr[t * kP + d] = rv;
      sk[t * kP + d] = kv;
      sv[t * kP + d] = vv;
      sla[(t + 1) * kP + d] = lw;
    }
    __syncthreads();

    // 2. running sum of log w over the chunk, one thread per channel
    if (tid < kHD) {
      float acc = 0.0f;
      for (int t = 1; t <= kC; ++t) {
        acc += sla[t * kP + tid];
        sla[t * kP + tid] = acc;
      }
    }
    __syncthreads();

    // 3. att: thread (ty, tx) owns rows t = 4ty+a, columns i = 4tx+c
    {
      float acc[4][4] = {};
      if (tx <= ty) {
        const bool diag = tx == ty;
#pragma unroll 4
        for (int d = 0; d < kHD; ++d) {
          float ra[4], lp[4], kc[4], li[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            ra[a] = sr[(4 * ty + a) * kP + d];
            lp[a] = sla[(4 * ty + a) * kP + d];        // la_prev[t]
            kc[a] = sk[(4 * tx + a) * kP + d];
            li[a] = sla[(4 * tx + a + 1) * kP + d];    // la[i]
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (!diag || c < a)                      // i < t only
                acc[a][c] += ra[a] * kc[c] * exp2f(lp[a] - li[c]);
        }
        if (diag) {                                    // the u bonus, i == t
          for (int d = 0; d < kHD; ++d) {
#pragma unroll
            for (int a = 0; a < 4; ++a)
              acc[a][a] += sr[(4 * ty + a) * kP + d] * su[d] *
                           sk[(4 * ty + a) * kP + d];
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          att[(4 * ty + a) * kP + 4 * tx + c] = acc[a][c];
    }
    __syncthreads();

    // 4. r <- r * exp(la_prev), k <- k * exp(la_C - la), in place
    const float* laC = sla + kC * kP;
    for (int e = tid; e < kC * kHD; e += kThreads) {
      const int t = e / kHD, d = e % kHD;
      sr[t * kP + d] *= exp2f(sla[t * kP + d]);
      sk[t * kP + d] *= exp2f(laC[d] - sla[(t + 1) * kP + d]);
    }
    __syncthreads();

    // 5. out = inter + att @ v: thread owns rows t = 4ty+a, columns
    //    j = tx + 16c (a warp's lanes read 16 consecutive columns)
    {
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < kHD; ++d) {
        float ra[4], s[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ra[a] = sr[(4 * ty + a) * kP + d];
          s[a] = sS[d * kP + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += ra[a] * s[c];
      }
      const int i_end = min(4 * ty + 4, L);            // att[t,i] = 0, i > t
      for (int i = 0; i < i_end; ++i) {
        float at[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          at[a] = att[(4 * ty + a) * kP + i];
          vv[a] = sv[i * kP + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += at[a] * vv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = 4 * ty + a;
        if (t >= L) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          if (j < hd) out[base + (long long)(t0 + t) * row + j] = acc[a][c];
        }
      }
    }
    __syncthreads();     // every thread has read S before any updates it

    // 6. S <- exp(la_C) * S + kA^T @ v: thread owns rows d = 4ty+a,
    //    columns j = tx + 16c
    {
      float acc[4][4] = {};
      for (int t = 0; t < L; ++t) {
        float ka[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ka[a] = sk[t * kP + 4 * ty + a];
          vv[a] = sv[t * kP + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += ka[a] * vv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int d = 4 * ty + a;
        const float decay = exp2f(laC[d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = sS + d * kP + tx + 16 * c;
          *s = decay * *s + acc[a][c];
        }
      }
    }
  }
  __syncthreads();

  float* so = s_out + (long long)bh * hd * hd;
  for (int e = tid; e < kHD * kHD; e += kThreads) {
    const int d = e / kHD, j = e % kHD;
    if (d < hd && j < hd) so[d * hd + j] = sS[d * kP + j];
  }
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const float* logw,
           const float* u, const float* s_in, float* out, float* s_out,
           int B, int T_len, int H, int hd, cudaStream_t stream) {
  if (hd < 1 || hd > kHD || T_len < 0 || B < 0 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    rwkv6_scan_kernel<T><<<B * H, kThreads, kSmemBytes, stream>>>(
        r, k, v, logw, u, s_in, out, s_out, T_len, H, hd);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface: r/k/v/logw/out [B,T,H,hd], u [H,hd], s_in/s_out [B,H,hd,hd],
// all contiguous; launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" {

int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* s_in,
                   float* out, float* s_out, int B, int T_len, int H, int hd,
                   cudaStream_t stream) {
  return launch(r, k, v, logw, u, s_in, out, s_out, B, T_len, H, hd, stream);
}

int rwkv6_scan_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, const float* logw, const float* u,
                    const float* s_in, float* out, float* s_out, int B,
                    int T_len, int H, int hd, cudaStream_t stream) {
  return launch(r, k, v, logw, u, s_in, out, s_out, B, T_len, H, hd, stream);
}

}  // extern "C"
