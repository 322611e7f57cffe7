// Hand-written Hopper kernel for the RWKV6 time-mix scan (K5).  Built by
// nvcc for sm_90a into the port's shared library with a plain C interface
// (repro_torch/kernels/build.py) and called through ctypes
// (repro_torch/kernels/rwkv6_scan/kernel.py).
//
// Replaces (JAX package): src/repro/kernels/rwkv6_scan/kernel.py:71
// `rwkv6_scan` (body `_kernel` :28), the chunked linear-attention scan.
// Per (batch, head), for chunks of kC tokens, with la = running sum of
// log w over the chunk and la_prev[t] = la[t-1]:
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
//   C = hd = 64) is never built; only att [C,C] is kept.  Every exponent
//   is a difference la[a] - la[b] with a >= b, which is <= 0 exactly (a
//   running sum of non-positive terms never increases in floating
//   point), so a steep decay underflows to 0 and never becomes
//   inf * 0 = NaN.
// * Decays are kept in log2 units and exponentiated on the SFU
//   (ex2.approx.ftz, ~2 ulp; a result below 2^-126 flushes to 0).
// * The chunk inside the kernel is kC = 64 and T need not be a multiple of
//   it: rows past T load as r = k = v = log w = 0 and are not stored.  The
//   chunk length does not change the result.
//
// What bounds it on an H100: operations.  At B=4, T=1024, H=64, hd=64 with
// bf16 r/k/v it moves ~243 MB (0.073 ms at 3.35 TB/s) and needs ~5.1 G
// operations counting each exp as one (0.077 ms at 67 TFLOP/s f32).
// What the design does about it:
// * The three products (out = [rA | att] @ [S ; v] as one K = hd + L
//   product, and kA^T @ v) run on the tensor cores, as warp-level
//   mma.sync.m16n8k8 TF32 products with f32 accumulators.  TF32 keeps 11
//   bits of each operand, about 5e-4 relative, which cannot be relied on
//   to meet the reference's 2e-4, so each operand is split as
//   hi = tf32(x), lo = tf32(x - hi) and each product is
//   hi*hi + hi*lo + lo*hi (3xTF32; the dropped lo*lo is ~2^-22 relative).
//   v widened from bf16 is exact in TF32, so its zero lo term is skipped
//   in the bf16 kernel.  The decay exponents stay f32 on the CUDA cores:
//   only the scaled operands go through the tensor cores.  Fragments are
//   formed from shared memory by each lane at the documented m16n8k8
//   positions, so operands can be scaled while they are loaded and the
//   accumulators are stored straight to device memory, masking the
//   ragged rows.
// * att is split into 16-row sub-chunks, with e_J the last row of
//   sub-chunk J.  Only the four diagonal blocks keep the pairwise form on
//   the CUDA cores, 120 pairs each (31 k exps a chunk instead of 129 k),
//   two warps a block with an equal share each.  After them every decay
//   is factored at the sub-chunk boundaries: in place,
//   r' = r * 2^(la_prev - la[e_{J-1}]) and k' = k * 2^(la[e_J] - la), so
//   each of the six blocks below the diagonal, I > J, is one 16x16x64
//   product att[I,J] = (r'[I] * 2^(la[e_{I-1}] - la[e_J])) @ k'[J]^T,
//   and rA = r' * 2^la[e_{J-1}], kA = k' * 2^(la_C - la[e_J]).  Every
//   exponent is <= 0 (la never increases), so a factor that underflows
//   to 0 stands for a product smaller still; a reference point at the
//   chunk's start would overflow one factor and underflow the other
//   (inf * 0).  One exp per element of r and of k, one per column and
//   sub-chunk for the rest.
// * Each thread issues all its 16-byte loads of a chunk before it stores
//   any (where rows start on 16 bytes), so a chunk pays one memory
//   latency, not one per element.
// * The running sum of log w is four segments of 16 rows scanned in
//   parallel; each segment starts from the exact last value of the one
//   before, so la stays non-increasing in floating point.
//
// Shared memory per block, in floats.  Rows read as an mma A operand by
// row (lanes over 8 rows x 4 columns) have a stride of 68 (= 4 mod 32 banks),
// rows read as a B operand by column (lanes over 4 rows x 8 columns) 72
// (= 8 mod 32):
//   S [64][72], v [64][72], r [64][68] (then r', then rA), k [64][68]
//   (then k', then kA), att [64][68], la [65][68] (row 0 = 0, row
//   t+1 = la[t], so row t = la_prev[t]), segment sums [4][64], u [64];
//   att above its diagonal is zeroed once and never written
// = 108,048 bytes: dynamic shared memory above the 48 KB default, two
// blocks per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHD = 64;          // largest head dim the kernel takes
constexpr int kC = 64;           // chunk length inside the kernel
constexpr int kPA = kHD + 4;     // row stride of r, k, att, la
constexpr int kPB = kHD + 8;     // row stride of S, v
constexpr int kThreads = 256;    // 8 warps
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmemFloats =
    2 * kHD * kPB + 3 * kC * kPA + (kC + 1) * kPA + 4 * kHD + kHD;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the 16 bytes of x (4 floats or 8 bf16), widened to f32, to dst
__device__ __forceinline__ void store_f32(float* dst, const uint4& x, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
      __uint_as_float(x.w));
}
__device__ __forceinline__ void store_f32(float* dst, const uint4& x,
                                          __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// 2^x for x <= 0
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- 3xTF32 tensor-core products (mma.sync.m16n8k8, row.col) ----------
// Lane l holds, with g = l / 4 and q = l % 4 (PTX ISA, mma.m16n8k8 .tf32):
//   A 16x8:  a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4)
//   B 8x8:   b0 (q, g), b1 (q+4, g)                      (row = k)
//   C 16x8:  c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a @ b in 3xTF32, the small terms first; with b_exact (b.lo = 0:
// b was bf16, which TF32 holds exactly) the zero a.hi @ b.lo is skipped
template <bool b_exact = false>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi);
  if (!b_exact) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// A = M[0:16, 0:8] of a row-major M (p = &M[0][0], row stride ld)
__device__ __forceinline__ void load_a(FragA& f, const float* p, int ld,
                                       int g, int q) {
  split(p[g * ld + q], f.hi[0], f.lo[0]);
  split(p[(g + 8) * ld + q], f.hi[1], f.lo[1]);
  split(p[g * ld + q + 4], f.hi[2], f.lo[2]);
  split(p[(g + 8) * ld + q + 4], f.hi[3], f.lo[3]);
}

// A = M[0:8, 0:16]^T of a row-major M
__device__ __forceinline__ void load_a_t(FragA& f, const float* p, int ld,
                                         int g, int q) {
  split(p[q * ld + g], f.hi[0], f.lo[0]);
  split(p[q * ld + g + 8], f.hi[1], f.lo[1]);
  split(p[(q + 4) * ld + g], f.hi[2], f.lo[2]);
  split(p[(q + 4) * ld + g + 8], f.hi[3], f.lo[3]);
}

// B = M[0:8, 0:8] of a row-major M (rows are k)
__device__ __forceinline__ void load_b(FragB& f, const float* p, int ld,
                                       int g, int q) {
  split(p[q * ld + g], f.hi[0], f.lo[0]);
  split(p[(q + 4) * ld + g], f.hi[1], f.lo[1]);
}

// (t, i), i < t, of pair p of the 120 in a 16x16 block, row by row
__device__ __forceinline__ void pair_of(int p, int& t, int& i) {
  t = 1;
  while (p >= t) {
    p -= t;
    ++t;
  }
  i = p;
}

// sum over d..d+3 of r[t,d] k[i,d] 2^(la_prev[t,d] - la[i,d]) in float4
// reads: 8 lanes on 8 rows of stride 68 cover the 32 banks once
__device__ __forceinline__ float decayed_dot4(const float* rt,
                                              const float* lpt,
                                              const float* ki,
                                              const float* lai) {
  const float4 rv = *reinterpret_cast<const float4*>(rt);
  const float4 pv = *reinterpret_cast<const float4*>(lpt);
  const float4 kv = *reinterpret_cast<const float4*>(ki);
  const float4 lv = *reinterpret_cast<const float4*>(lai);
  return rv.x * kv.x * exp2_neg(pv.x - lv.x) +
         rv.y * kv.y * exp2_neg(pv.y - lv.y) +
         rv.z * kv.z * exp2_neg(pv.z - lv.z) +
         rv.w * kv.w * exp2_neg(pv.w - lv.w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ s_in,
                  float* __restrict__ out, float* __restrict__ s_out,
                  int T_len, int H, int hd, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                  // [kHD][kPB]
  float* sv = sS + kHD * kPB;        // [kC][kPB]
  float* sr = sv + kC * kPB;         // [kC][kPA]
  float* sk = sr + kC * kPA;         // [kC][kPA]
  float* att = sk + kC * kPA;        // [kC][kPA]
  float* sla = att + kC * kPA;       // [kC + 1][kPA]
  float* sseg = sla + (kC + 1) * kPA;  // [4][kHD]
  float* su = sseg + 4 * kHD;        // [kHD]
  const float* laC = sla + kC * kPA; // la of the chunk's last row

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;         // b * H + h
  const int b = bh / H, h = bh % H;
  const long long row = (long long)H * hd;             // t -> t+1
  const long long base = (long long)b * T_len * row + (long long)h * hd;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;                // mma lane coords
  // the products: warp w owns column block jc of out and S, and the row
  // blocks ib0 and 3 - ib0, which balances the causal att @ v
  const int jc = warp / 2, ib0 = warp % 2;
  // the diagonal blocks of att: lane lt of a warp pair, its pairs (t, i)
  const int lt = (warp % 2) * 32 + lane;
  int pt[2], pi[2];
  pair_of(lt, pt[0], pi[0]);
  pair_of(min(lt + 64, 119), pt[1], pi[1]);
  const int n4 = (hd + 3) / 4 * 4;   // d range of the pairwise sums

  const float* sin_bh = s_in + (long long)bh * hd * hd;
  for (int e = tid; e < kHD * kHD; e += kThreads) {
    const int d = e / kHD, j = e % kHD;
    sS[d * kPB + j] = (d < hd && j < hd) ? sin_bh[d * hd + j] : 0.0f;
  }
  for (int d = tid; d < kHD; d += kThreads) {
    su[d] = d < hd ? u[h * hd + d] : 0.0f;
    sla[d] = 0.0f;                   // row 0: la_prev of the first token
  }
  // v, r, k, att, la start at 0: the 16-byte loads never write columns
  // d >= hd, and no phase writes att above its diagonal
  for (int e = tid; e < kC * kPB + 3 * kC * kPA + (kC + 1) * kPA;
       e += kThreads) {
    sv[e] = 0.0f;
  }

  for (int t0 = 0; t0 < T_len; t0 += kC) {
    const int L = min(kC, T_len - t0);
    __syncthreads();     // the last chunk's readers of r/k/v/la/S are done

    // 1. load the chunk as f32, log w in log2 units; rows >= L are zero.
    //    With vec, every thread first issues all its 16-byte loads (2-4 of
    //    each operand), so one memory latency is paid a chunk, not 16.
    if (vec) {
      constexpr int EV = 16 / sizeof(T);               // r/k/v a load
      constexpr int NV = kC * kHD / EV / kThreads;     // loads a thread
      constexpr int NW = kC * kHD / 4 / kThreads;
      const int vr = hd / EV, vw = hd / 4;             // loads a row
      uint4 xr[NV], xk[NV], xv[NV];
      float4 xw[NW];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = tid + i * kThreads, t = e / vr;
        xr[i] = xk[i] = xv[i] = make_uint4(0, 0, 0, 0);
        if (t < L) {
          const long long gi = base + (long long)(t0 + t) * row + e % vr * EV;
          xr[i] = *reinterpret_cast<const uint4*>(r + gi);
          xk[i] = *reinterpret_cast<const uint4*>(k + gi);
          xv[i] = *reinterpret_cast<const uint4*>(v + gi);
        }
      }
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const int e = tid + i * kThreads, t = e / vw;
        xw[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t < L) {
          xw[i] = *reinterpret_cast<const float4*>(
              logw + base + (long long)(t0 + t) * row + e % vw * 4);
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = tid + i * kThreads, t = e / vr, c = e % vr * EV;
        if (t < kC) {
          store_f32(sr + t * kPA + c, xr[i], T());
          store_f32(sk + t * kPA + c, xk[i], T());
          store_f32(sv + t * kPB + c, xv[i], T());
        }
      }
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const int e = tid + i * kThreads, t = e / vw;
        if (t < kC) {
          *reinterpret_cast<float4*>(sla + (t + 1) * kPA + e % vw * 4) =
              make_float4(xw[i].x * kLog2e, xw[i].y * kLog2e,
                          xw[i].z * kLog2e, xw[i].w * kLog2e);
        }
      }
    } else {
      for (int e = tid; e < kC * kHD; e += kThreads) {
        const int t = e / kHD, d = e % kHD;
        float rv = 0.0f, kv = 0.0f, vv = 0.0f, lw = 0.0f;
        if (t < L && d < hd) {
          const long long gi = base + (long long)(t0 + t) * row + d;
          rv = to_f32(r[gi]);
          kv = to_f32(k[gi]);
          vv = to_f32(v[gi]);
          lw = logw[gi] * kLog2e;
        }
        sr[t * kPA + d] = rv;
        sk[t * kPA + d] = kv;
        sv[t * kPB + d] = vv;
        sla[(t + 1) * kPA + d] = lw;
      }
    }
    __syncthreads();

    // 2. running sum of log w: thread (s, d) scans rows 16s..16s+15 of
    //    channel d, then adds the sum of the segments before, formed in
    //    the same order as their last rows
    {
      const int s = tid / kHD, d = tid % kHD;
      float* col = sla + (16 * s + 1) * kPA + d;
      float part[16];
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        acc += col[m * kPA];
        part[m] = acc;
      }
      sseg[s * kHD + d] = acc;
      __syncthreads();
      float off = 0.0f;
      for (int p = 0; p < s; ++p) off += sseg[p * kHD + d];
#pragma unroll
      for (int m = 0; m < 16; ++m) col[m * kPA] = off + part[m];
    }
    __syncthreads();

    // 3. att.  a) The four 16x16 diagonal blocks in the exact pairwise
    //    form on the CUDA cores, warps 2J and 2J+1 on block J: lane lt
    //    sums pairs lt and lt+64 of the block's 120 in one loop (lanes
    //    lt >= 56 repeat pair 119 and do not store it), then every four
    //    lanes sum the u bonus of one row, a quarter of d each.
    {
      const int o = 16 * (warp / 2);
      const float* r0 = sr + (o + pt[0]) * kPA;
      const float* p0 = sla + (o + pt[0]) * kPA;       // la_prev[t]
      const float* k0 = sk + (o + pi[0]) * kPA;
      const float* l0 = sla + (o + pi[0] + 1) * kPA;   // la[i]
      const float* r1 = sr + (o + pt[1]) * kPA;
      const float* p1 = sla + (o + pt[1]) * kPA;
      const float* k1 = sk + (o + pi[1]) * kPA;
      const float* l1 = sla + (o + pi[1] + 1) * kPA;
      float a0 = 0.0f, a1 = 0.0f;
      for (int d = 0; d < n4; d += 4) {
        a0 += decayed_dot4(r0 + d, p0 + d, k0 + d, l0 + d);
        a1 += decayed_dot4(r1 + d, p1 + d, k1 + d, l1 + d);
      }
      att[(o + pt[0]) * kPA + o + pi[0]] = a0;
      if (lt < 56) att[(o + pt[1]) * kPA + o + pi[1]] = a1;
      const int t = o + lt / 4;
      float b = 0.0f;
#pragma unroll
      for (int d = lt % 4 * 4; d < kHD; d += 16) {
        const float4 rv = *reinterpret_cast<const float4*>(sr + t * kPA + d);
        const float4 kv = *reinterpret_cast<const float4*>(sk + t * kPA + d);
        const float4 uv = *reinterpret_cast<const float4*>(su + d);
        b += rv.x * uv.x * kv.x + rv.y * uv.y * kv.y + rv.z * uv.z * kv.z +
             rv.w * uv.w * kv.w;
      }
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if (lt % 4 == 0) att[t * kPA + t] = b;
    }
    __syncthreads();

    // Every decay from here on is factored at the sub-chunk boundaries,
    // with the la of row e_J (the last row of sub-chunk J) in row
    // 16J + 16 of sla and that of row e_{J-1} in row 16J (0 for J = 0).
    // b) In place, row t of sub-chunk J:
    //      r <- r * 2^(la_prev[t] - la[e_{J-1}])    (t - 1 >= e_{J-1})
    //      k <- k * 2^(la[e_J] - la[t])             (e_J >= t)
    //    both exponents <= 0.  Thread tid keeps channel d = tid % 64.
    const int dc = tid % kHD;
#pragma unroll
    for (int m = 0; m < kC * kHD / kThreads; ++m) {
      const int t = tid / kHD + m * (kThreads / kHD), J = t / 16;
      sr[t * kPA + dc] *= exp2_neg(sla[t * kPA + dc] - sla[16 * J * kPA + dc]);
      sk[t * kPA + dc] *= exp2_neg(sla[(16 * J + 16) * kPA + dc] -
                                   sla[(t + 1) * kPA + dc]);
    }
    __syncthreads();

    //    c) The six blocks below the diagonal, I > J, as A B^T on the
    //    tensor cores, one warp a block: B = k[J] as it now stands and
    //    A = r[I] * 2^(la[e_{I-1}] - la[e_J]) (a factor per column, formed
    //    as the fragment loads), so att[I,J] = sum_d r[t,d] k[i,d]
    //    2^(la_prev[t,d] - la[i,d]) with every factor <= 1: one that
    //    underflows to 0 stands for a product smaller still, never inf * 0.
    if (warp < 6) {
      const int I = warp < 3 ? 3 : (warp < 5 ? 2 : 1);
      const int J = warp < 3 ? warp : (warp < 5 ? warp - 3 : 0);
      const float* lI = sla + 16 * I * kPA;              // la[e_{I-1}]
      const float* lJ = sla + (16 * J + 16) * kPA;       // la[e_J]
      const float* rI = sr + 16 * I * kPA;
      const float* kJ = sk + 16 * J * kPA;
      float acc[2][4] = {};
      for (int k0 = 0; k0 < hd; k0 += 8) {
        const int c0 = k0 + q, c1 = k0 + q + 4;
        const float f0 = exp2_neg(lI[c0] - lJ[c0]);
        const float f1 = exp2_neg(lI[c1] - lJ[c1]);
        FragA fa;
        split(rI[g * kPA + c0] * f0, fa.hi[0], fa.lo[0]);
        split(rI[(g + 8) * kPA + c0] * f0, fa.hi[1], fa.lo[1]);
        split(rI[g * kPA + c1] * f1, fa.hi[2], fa.lo[2]);
        split(rI[(g + 8) * kPA + c1] * f1, fa.hi[3], fa.lo[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          FragB fb;
          split(kJ[(8 * nt + g) * kPA + c0], fb.hi[0], fb.lo[0]);
          split(kJ[(8 * nt + g) * kPA + c1], fb.hi[1], fb.lo[1]);
          mma3(acc[nt], fa, fb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          att[(16 * I + g + 8 * (e / 2)) * kPA + 16 * J + 8 * nt + 2 * q +
              e % 2] = acc[nt][e];
    }
    __syncthreads();

    // 4. r <- r * 2^la[e_{J-1}] = r * 2^la_prev and
    //    k <- k * 2^(la_C - la[e_J]) = k * 2^(la_C - la), in place: one
    //    factor per channel and sub-chunk
#pragma unroll
    for (int J = 0; J < kC / 16; ++J) {
      const float fr = exp2_neg(sla[16 * J * kPA + dc]);
      const float fk = exp2_neg(laC[dc] - sla[(16 * J + 16) * kPA + dc]);
#pragma unroll
      for (int m = 0; m < 16 * kHD / kThreads; ++m) {
        const int t = 16 * J + tid / kHD + m * (kThreads / kHD);
        sr[t * kPA + dc] *= fr;
        sk[t * kPA + dc] *= fk;
      }
    }
    __syncthreads();

    // 5. on the tensor cores: out = [rA | att] @ [S ; v] and
    //    S <- exp(la_C) * S + kA^T @ v, both 16x16 blocks (two m16n8
    //    tiles) at rows ib[x], columns jc
    {
      // v widened from bf16 is exact in TF32
      constexpr bool v_exact = sizeof(T) == 2;
      const int ib[2] = {ib0, 3 - ib0};
      float ao[2][2][4], as[2][2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 16 * ib[x] + g + 8 * (e / 2);
            const int j = 16 * jc + 8 * nt + 2 * q + e % 2;
            ao[x][nt][e] = 0.0f;
            as[x][nt][e] = exp2_neg(laC[d]) * sS[d * kPB + j];
          }
      FragA fa;
      FragB fb[2];
      for (int k0 = 0; k0 < hd; k0 += 8) {             // inter: K over d
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          load_b(fb[nt], sS + k0 * kPB + 16 * jc + 8 * nt, kPB, g, q);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          load_a(fa, sr + 16 * ib[x] * kPA + k0, kPA, g, q);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma3(ao[x][nt], fa, fb[nt]);
        }
      }
      for (int k0 = 0; k0 < L; k0 += 8) {              // K over tokens
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          load_b(fb[nt], sv + k0 * kPB + 16 * jc + 8 * nt, kPB, g, q);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (k0 < 16 * (ib[x] + 1)) {                 // att[t,i] = 0, i > t
            load_a(fa, att + 16 * ib[x] * kPA + k0, kPA, g, q);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma3<v_exact>(ao[x][nt], fa, fb[nt]);
          }
          load_a_t(fa, sk + k0 * kPA + 16 * ib[x], kPA, g, q);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3<v_exact>(as[x][nt], fa, fb[nt]);
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * ib[x] + g + 8 * (e / 2);
            const int j = 16 * jc + 8 * nt + 2 * q + e % 2;
            if (t < L && j < hd)
              out[base + (long long)(t0 + t) * row + j] = ao[x][nt][e];
          }
      __syncthreads();   // every warp has read S before any updates it
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 16 * ib[x] + g + 8 * (e / 2);
            const int j = 16 * jc + 8 * nt + 2 * q + e % 2;
            sS[d * kPB + j] = as[x][nt][e];
          }
    }
  }
  __syncthreads();

  float* so = s_out + (long long)bh * hd * hd;
  for (int e = tid; e < kHD * kHD; e += kThreads) {
    const int d = e / kHD, j = e % kHD;
    if (d < hd && j < hd) so[d * hd + j] = sS[d * kPB + j];
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
  // 16-byte loads of r/k/v and log w where every row of hd starts on 16
  // bytes
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool vec = hd % (16 / sizeof(T)) == 0 && hd % 4 == 0 &&
                   aligned(r) && aligned(k) && aligned(v) && aligned(logw);
  if (B > 0) {
    rwkv6_scan_kernel<T><<<B * H, kThreads, kSmemBytes, stream>>>(
        r, k, v, logw, u, s_in, out, s_out, T_len, H, hd, vec);
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
