// Mamba2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py :: ssd_scan_kernel
// (pallas_call at ssd_scan.py:86). Same contract: per (sequence b, head h)
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,   y_t = C_t h_t + D x_t
// from a zero state, with dt_t = softplus(dt_raw + dt_bias[h]) and
// A = -exp(a_log[h]); x [B,T,H,P] and dt [B,T,H] (fp32 or bf16, read
// through their strides), b, c [B,T,N] (one B/C group), a_log / d_skip /
// dt_bias [H] -> y [B,T,H,P] contiguous in x's type and the final state
// [B,H,P,N] in fp32. Sums in fp32. Unlike the TPU wrapper it takes any T:
// rows past T in the last chunk get dt = 0, so they neither decay nor feed
// the state, which is what the wrapper's dt = -1e9 padding does.
//
// What bounds it on the card: device-memory bytes. At mamba2-780m widths
// (H 48, P 64, N 128) a 256-token prompt moves ~4.9 MB (x and y, B and C,
// the final state), 1.5 us at 3.35 TB/s, against ~0.7 GFLOP, 0.7 us at
// the bf16 tensor-core rate; on the CUDA cores (67 TFLOP/s fp32) the same
// work would take ~10 us, so the products must run on the tensor cores
// for the bytes to bound it. At serving sizes what remains is latency:
// three dependent launches, each a few microseconds.
//
// Design: the chunk-parallel form that the TPU kernel's docstring names
// (ssd_scan.py:4-7), in three passes over 64-step chunks; the TPU grid's
// sequential carry over chunks becomes pass 2. Per chunk, dt, its
// softplus and the in-chunk cumulative sum of dt A (in order, as
// jnp.cumsum adds) are recomputed where needed.
// 1. Chunk states, grid (chunk x P tile, head, sequence): the state the
//    chunk adds from a zero start, S_c = sum_k exp(cum_last - cum_k) dt_k
//    x_k B_k^T, a [P,Q] x [Q,N] product, and the chunk decay
//    exp(cum_last), into an fp32 workspace [B,H,nc,P,N] the wrapper
//    allocates.
// 2. State passing, a thread per four elements (b, h, p, n..n+3):
//    h_c = decay_c h_{c-1} + S_c over the chunks in order; each chunk's incoming state replaces
//    its S_c in the workspace (chunk 0's is zero and is not written), the
//    last is the final state.
// 3. Chunk outputs, grid as pass 1: y = (L o C B^T o dt_k) x +
//    exp(cum_q) C h_in + D x, the decay masked BEFORE exp (cum_q - cum_k
//    > 0 above the diagonal would overflow), as ssm.py warns.
// Two bodies for passes 1 and 3, picked on the host (kernels/ssd_scan.py
// `body`):
// - tensor cores, bf16 with P % 32 == 0, N % 16 == 0 and N <= 128 (both
//   served archs: mamba2-780m N 128, hymba-1.5b N 16): 4 warps, a block
//   per 32 P columns, mma.sync m16n8k16. C B^T takes the bf16 inputs
//   exactly; the three fp32 operands (the decay-weighted x of the state
//   product, the decay-weighted scores, the carried state h_in) go through
//   as two bf16 parts each, hi + lo, so they keep ~16 bits: the final
//   state feeds every decode step of the request. Pass 3's scores come
//   out of their product in the A-fragment layout of the next, as P does
//   in flash attention.
// - CUDA cores, fp32 and the other widths: a block per (chunk, head),
//   operands staged in fp32 shared memory, one output element a thread at
//   a time.
// The three kernels are one launch of this function.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kQ = 64;              // chunk length
constexpr int kPT = 32;             // P columns of a tensor-core block
constexpr int kMaxNTc = 128;        // widest N of the tensor-core body
constexpr int kMaxSmem = 232448;    // H100 opt-in shared memory a block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// log(1 + e^v) as jax.nn.softplus computes it (logaddexp(v, 0))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

struct Strides {                    // element strides of the inputs
  long long xb, xt, xh;             // x [B,T,H,P], P contiguous
  long long db, dt;                 // dt [B,T,H], H contiguous
  long long bb, bt, cb, ct;         // b, c [B,T,N], N contiguous
};

struct Args {
  const void* x;
  const void* dt;
  const void* a_log;
  const void* d_skip;
  const void* dt_bias;
  const void* b;
  const void* c;
  void* y;
  float* hout;                      // [B,H,P,N]
  float* ws;                        // [B,H,nc,P,N]: S_c, then h_in
  float* decay;                     // [B,H,nc]: exp(cum_last)
  int B, T, H, P, N, nc;
  int vec;                          // x, b, c rows 16-byte aligned
  Strides s;
};

// dtp[k] = softplus(dt + bias) for the chunk's rows (0 past T) and cum[k]
// the inclusive cumulative sum of dtp*A; block-wide, ends with a barrier.
// Thread k adds dtp[0..k]*A itself, in order, so every cum[k] is rounded
// exactly as one sequential cumsum (jnp.cumsum) rounds it, with the 64
// sums running side by side.
template <typename T>
__device__ void chunk_decay(const Args& a, int b, int h, int t0, int n,
                            float* dtp, float* cum) {
  const T* dtr = static_cast<const T*>(a.dt);
  const float A = -expf(to_f(static_cast<const T*>(a.a_log)[h]));
  const float bias = to_f(static_cast<const T*>(a.dt_bias)[h]);
  for (int t = threadIdx.x; t < kQ; t += blockDim.x)
    dtp[t] = t < n ? softplus(to_f(dtr[b * a.s.db + (t0 + t) * a.s.dt + h]) +
                              bias)
                   : 0.f;
  __syncthreads();
  for (int t = threadIdx.x; t < kQ; t += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k <= t; ++k) acc = __fadd_rn(acc, __fmul_rn(dtp[k], A));
    cum[t] = acc;
  }
  __syncthreads();
}

// ------------------------------------------------------ tensor-core body

using bf16 = __nv_bfloat16;

// 8 consecutive bf16 values from global memory: one 16-byte load where the
// caller's rows are aligned, else one at a time.
__device__ __forceinline__ uint4 load8(const bf16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 u;
  uint16_t* e = reinterpret_cast<uint16_t*>(&u);
  const uint16_t* src = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = src[i];
  return u;
}

constexpr int kInFlight = 8;        // loads a thread issues before storing

// rows [n][cols] of a [.., cols] operand (row stride `ld` elements) into
// shared memory [kQ][cols + 8]; rows n..kQ-1 zero. cols % 8 == 0. Each
// thread issues up to kInFlight loads into registers before it stores
// any, so their latencies overlap (a store to shared memory through a
// generic pointer would otherwise order the next load behind it).
__device__ void stage_rows(bf16* dst, const bf16* src, long long ld, int n,
                           int cols, bool vec) {
  const int ch = cols / 8;
  const int total = kQ * ch;
  for (int i0 = threadIdx.x; i0 < total; i0 += kInFlight * blockDim.x) {
    uint4 u[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j * blockDim.x;
      const int r = i / ch, c8 = (i % ch) * 8;
      u[j] = i < total && r < n ? load8(src + r * ld + c8, vec)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < total)
        *reinterpret_cast<uint4*>(dst + (i / ch) * (cols + 8) +
                                  (i % ch) * 8) = u[j];
    }
  }
}

// v = hi + lo with both parts in bf16 (hi keeps v's top 8 bits, lo the
// next 8)
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// Pass 1 on the tensor cores: S_c[p0..p0+32, 0..N) for one (chunk, head,
// sequence). Warp w takes the 16 P rows (w % 2) and half (w / 2) of the N
// columns; A = (w x)^T from the hi / lo tiles by ldmatrix.trans, B = the
// chunk's B rows by ldmatrix.trans.
__global__ void __launch_bounds__(128)
state_tc_kernel(Args a) {
  constexpr int XS = kPT + 8;                   // x tile row stride
  const int npt = a.P / kPT;
  const int ck = blockIdx.x / npt, p0 = (blockIdx.x % npt) * kPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = ck * kQ, n = min(kQ, a.T - t0);
  const int N = a.N, BS = N + 8;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xh = reinterpret_cast<bf16*>(smem);     // [kQ][XS] hi of w_k x_k
  bf16* xl = xh + kQ * XS;                      // [kQ][XS] lo
  bf16* bs = xl + kQ * XS;                      // [kQ][BS]
  float* dtp = reinterpret_cast<float*>(bs + kQ * BS);     // [kQ]
  float* cum = dtp + kQ;                                   // [kQ]
  float* wk = cum + kQ;                                    // [kQ]

  const bool vec = a.vec != 0;
  // this thread's x pieces in registers first (scaled once the decays
  // are known), so their loads overlap B's
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.s.xb +
                   t0 * a.s.xt + h * a.s.xh + p0;
  constexpr int kXLoads = kQ * (kPT / 8) / 128;  // x loads a thread
  uint4 u[kXLoads];
#pragma unroll
  for (int j = 0; j < kXLoads; ++j) {
    const int i = tid + j * 128;
    const int k = i / (kPT / 8), c8 = (i % (kPT / 8)) * 8;
    u[j] = k < n ? load8(xb + k * a.s.xt + c8, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  stage_rows(bs, static_cast<const bf16*>(a.b) + b * a.s.bb + t0 * a.s.bt,
             a.s.bt, n, N, vec);
  chunk_decay<bf16>(a, b, h, t0, n, dtp, cum);
  const float cl = cum[kQ - 1];
  for (int k = tid; k < kQ; k += blockDim.x) wk[k] = dtp[k] * expf(cl - cum[k]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kXLoads; ++j) {
    const int i = tid + j * 128;
    const int k = i / (kPT / 8), c8 = (i % (kPT / 8)) * 8;
    const bf16* e = reinterpret_cast<const bf16*>(&u[j]);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      split_bf16(wk[k] * __bfloat162float(e[c]), xh[k * XS + c8 + c],
                 xl[k * XS + c8 + c]);
  }
  if (tid == 0 && p0 == 0)
    a.decay[((size_t)b * a.H + h) * a.nc + ck] = expf(cl);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int pm = (warp % 2) * 16;               // P rows of this warp
  const int ntw = N / 16;                       // n-tiles of 8 a warp
  const int nb0 = (warp / 2) * (N / 2);         // its first column
  const int gq = lane / 4, tq = lane % 4;
  float acc[kMaxNTc / 16][4];
#pragma unroll
  for (int j = 0; j < kMaxNTc / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kQ; k0 += 16) {
    uint32_t ah[4], al[4];
    const int arow = k0 + lane % 8 + 8 * (lane / 16);
    const int acol = pm + 8 * ((lane / 8) % 2);
    hopper::ldmatrix_x4_trans(ah, hopper::smem_addr(xh + arow * XS + acol));
    hopper::ldmatrix_x4_trans(al, hopper::smem_addr(xl + arow * XS + acol));
#pragma unroll
    for (int j = 0; j < kMaxNTc / 16; j += 2) {
      if (j >= ntw) continue;     // unrolled: no dynamic register index
      // matrix i: B rows k0 + 8(i%2).., columns nb0 + 8(j + i/2)..
      uint32_t bf[4];
      hopper::ldmatrix_x4_trans(
          bf, hopper::smem_addr(bs + (k0 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                         BS + nb0 + 8 * (j + lane / 16)));
      hopper::mma_16816(acc[j], ah, bf[0], bf[1]);
      hopper::mma_16816(acc[j], al, bf[0], bf[1]);
      hopper::mma_16816(acc[j + 1], ah, bf[2], bf[3]);
      hopper::mma_16816(acc[j + 1], al, bf[2], bf[3]);
    }
  }
  float* ws = a.ws + (((size_t)b * a.H + h) * a.nc + ck) * a.P * N;
#pragma unroll
  for (int j = 0; j < kMaxNTc / 16; ++j) {
    if (j >= ntw) continue;
    const int col = nb0 + 8 * j + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = p0 + pm + gq + 8 * i;
      *reinterpret_cast<float2*>(ws + (size_t)p * N + col) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// Pass 3 on the tensor cores: y[t0.., h, p0..p0+32) for one (chunk, head,
// sequence). Warp w takes the 16 rows q = 16w..: the inter-chunk term
// C h_in^T (h_in as hi + lo), scaled by exp(cum_q); the scores C B^T over
// the key blocks at or below its rows, weighted and masked in registers,
// then (as hi + lo A fragments) times the chunk's x; then D x.
__global__ void __launch_bounds__(128)
out_tc_kernel(Args a) {
  constexpr int XS = kPT + 8;
  const int npt = a.P / kPT;
  const int ck = blockIdx.x / npt, p0 = (blockIdx.x % npt) * kPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = ck * kQ, n = min(kQ, a.T - t0);
  const int N = a.N, BS = N + 8;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);     // [kQ][BS]
  bf16* bs = cs + kQ * BS;                      // [kQ][BS]
  bf16* xs = bs + kQ * BS;                      // [kQ][XS]
  bf16* hh = xs + kQ * XS;                      // [kPT][BS] hi of h_in
  bf16* hl = hh + kPT * BS;                     // [kPT][BS] lo
  float* dtp = reinterpret_cast<float*>(hl + kPT * BS);    // [kQ]
  float* cum = dtp + kQ;                                   // [kQ]

  const bool vec = a.vec != 0;
  const bool inter = ck > 0;                    // h_in is zero in chunk 0
  // h_in's kPT*N/4 <= kInFlight * 128 float4 pieces into registers first,
  // so their loads overlap the operands' below
  const float* hin = a.ws + (((size_t)b * a.H + h) * a.nc + ck) * a.P * N +
                     (size_t)p0 * N;
  const int hn = inter ? kPT * N / 4 : 0;
  float4 hv[kInFlight];
#pragma unroll
  for (int j = 0; j < kInFlight; ++j) {
    const int i = tid + j * blockDim.x;
    if (i < hn) hv[j] = *reinterpret_cast<const float4*>(hin + i * 4);
  }
  stage_rows(cs, static_cast<const bf16*>(a.c) + b * a.s.cb + t0 * a.s.ct,
             a.s.ct, n, N, vec);
  stage_rows(bs, static_cast<const bf16*>(a.b) + b * a.s.bb + t0 * a.s.bt,
             a.s.bt, n, N, vec);
  stage_rows(xs, static_cast<const bf16*>(a.x) + b * a.s.xb + t0 * a.s.xt +
                     h * a.s.xh + p0,
             a.s.xt, n, kPT, vec);
#pragma unroll
  for (int j = 0; j < kInFlight; ++j) {
    const int i = tid + j * blockDim.x;
    if (i >= hn) continue;
    const int p = (i * 4) / N, col = (i * 4) % N;
    const float e[4] = {hv[j].x, hv[j].y, hv[j].z, hv[j].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      split_bf16(e[c], hh[p * BS + col + c], hl[p * BS + col + c]);
  }
  chunk_decay<bf16>(a, b, h, t0, n, dtp, cum);  // ends with a barrier

  const int warp = tid / 32, lane = tid % 32;
  const int q0 = 16 * warp;
  const int gq = lane / 4, tq = lane % 4;
  const int ks = N / 16;                        // k-steps over N
  uint32_t ca[kMaxNTc / 16][4];                 // A fragments of C
#pragma unroll
  for (int kk = 0; kk < kMaxNTc / 16; ++kk) {
    if (kk >= ks) continue;
    hopper::ldmatrix_x4(
        ca[kk], hopper::smem_addr(cs + (q0 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                           BS + kk * 16 + 8 * (lane / 16)));
  }
  float y[kPT / 8][4];
#pragma unroll
  for (int j = 0; j < kPT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
  if (inter) {
#pragma unroll
    for (int kk = 0; kk < kMaxNTc / 16; ++kk) {
      if (kk >= ks) continue;
#pragma unroll
      for (int j = 0; j < kPT / 8; j += 2) {
        // B = h_in^T: matrix i is P rows 8(j + i/2).., N columns
        // kk*16 + 8(i%2)..
        const int off = (8 * j + lane % 8 + 8 * (lane / 16)) * BS + kk * 16 +
                        8 * ((lane / 8) % 2);
        uint32_t fh[4], fl[4];
        hopper::ldmatrix_x4(fh, hopper::smem_addr(hh + off));
        hopper::ldmatrix_x4(fl, hopper::smem_addr(hl + off));
        hopper::mma_16816(y[j], ca[kk], fh[0], fh[1]);
        hopper::mma_16816(y[j], ca[kk], fl[0], fl[1]);
        hopper::mma_16816(y[j + 1], ca[kk], fh[2], fh[3]);
        hopper::mma_16816(y[j + 1], ca[kk], fl[2], fl[3]);
      }
    }
    const float d0 = expf(cum[q0 + gq]), d1 = expf(cum[q0 + gq + 8]);
#pragma unroll
    for (int j = 0; j < kPT / 8; ++j) {
      y[j][0] *= d0;
      y[j][1] *= d0;
      y[j][2] *= d1;
      y[j][3] *= d1;
    }
  }
  // intra-chunk: key blocks kb = 0..q0 (16 keys each), causal
  for (int kb = 0; kb <= q0; kb += 16) {
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kMaxNTc / 16; ++kk) {
      if (kk >= ks) continue;
      // B = B^T: matrix i is keys kb + 8(i/2).., N columns kk*16 + 8(i%2)..
      uint32_t kf[4];
      hopper::ldmatrix_x4(
          kf, hopper::smem_addr(bs + (kb + lane % 8 + 8 * (lane / 16)) * BS +
                                kk * 16 + 8 * ((lane / 8) % 2)));
      hopper::mma_16816(sc[0], ca[kk], kf[0], kf[1]);
      hopper::mma_16816(sc[1], ca[kk], kf[2], kf[3]);
    }
    // L o (C B^T) o dt_k, masked before exp
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + gq + 8 * i;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = kb + 8 * j + 2 * tq + c;
          v[c] = k <= q ? sc[j][2 * i + c] * expf(cum[q] - cum[k]) * dtp[k]
                        : 0.f;
        }
        bf16 h0, l0, h1, l1;
        split_bf16(v[0], h0, l0);
        split_bf16(v[1], h1, l1);
        // A fragment: a0 = (row gq, keys 2tq..), a1 = (row gq+8, ..),
        // a2 = (row gq, keys 8 + 2tq..), a3 = (row gq+8, 8 + ..)
        __nv_bfloat162 hv = __halves2bfloat162(h0, h1);
        __nv_bfloat162 lv = __halves2bfloat162(l0, l1);
        ph[2 * j + i] = *reinterpret_cast<uint32_t*>(&hv);
        pl[2 * j + i] = *reinterpret_cast<uint32_t*>(&lv);
      }
#pragma unroll
    for (int j = 0; j < kPT / 8; j += 2) {
      // B = x: matrix i is keys kb + 8(i%2).., P columns 8(j + i/2)..
      uint32_t vf[4];
      hopper::ldmatrix_x4_trans(
          vf, hopper::smem_addr(xs + (kb + lane % 8 + 8 * ((lane / 8) % 2)) *
                                         XS + 8 * (j + lane / 16)));
      hopper::mma_16816(y[j], ph, vf[0], vf[1]);
      hopper::mma_16816(y[j], pl, vf[0], vf[1]);
      hopper::mma_16816(y[j + 1], ph, vf[2], vf[3]);
      hopper::mma_16816(y[j + 1], pl, vf[2], vf[3]);
    }
  }
  const float Dk = __bfloat162float(static_cast<const bf16*>(a.d_skip)[h]);
  bf16* yb = static_cast<bf16*>(a.y);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + gq + 8 * i;
    if (q >= n) continue;
    bf16* yr = yb + (((size_t)b * a.T + t0 + q) * a.H + h) * a.P + p0;
#pragma unroll
    for (int j = 0; j < kPT / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float x0 = __bfloat162float(xs[q * XS + col]);
      const float x1 = __bfloat162float(xs[q * XS + col + 1]);
      *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(
          y[j][2 * i] + Dk * x0, y[j][2 * i + 1] + Dk * x1);
    }
  }
}

// ---------------------------------------------------------- CUDA-core body

constexpr int kCcThreads = 256;

// Pass 1 on the CUDA cores: S_c[P,N] for one (chunk, head, sequence).
template <typename T>
__global__ void __launch_bounds__(kCcThreads)
state_cc_kernel(Args a) {
  const int ck = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = ck * kQ, n = min(kQ, a.T - t0);
  const int P = a.P, N = a.N, NP = N + 1;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [kQ][P]
  float* bs = xs + kQ * P;          // [kQ][NP]
  float* dtp = bs + kQ * NP;        // [kQ]
  float* cum = dtp + kQ;            // [kQ]
  float* wk = cum + kQ;             // [kQ]

  const T* xb = static_cast<const T*>(a.x) + b * a.s.xb + t0 * a.s.xt +
                h * a.s.xh;
  const T* bb = static_cast<const T*>(a.b) + b * a.s.bb + t0 * a.s.bt;
  for (int i = tid; i < kQ * P; i += kCcThreads) {
    const int k = i / P, p = i % P;
    xs[i] = k < n ? to_f(xb[k * a.s.xt + p]) : 0.f;
  }
  for (int i = tid; i < kQ * N; i += kCcThreads) {
    const int k = i / N, j = i % N;
    bs[k * NP + j] = k < n ? to_f(bb[k * a.s.bt + j]) : 0.f;
  }
  chunk_decay<T>(a, b, h, t0, n, dtp, cum);
  const float cl = cum[kQ - 1];
  if (tid < kQ) wk[tid] = dtp[tid] * expf(cl - cum[tid]);
  if (tid == 0) a.decay[((size_t)b * a.H + h) * a.nc + ck] = expf(cl);
  __syncthreads();
  float* ws = a.ws + (((size_t)b * a.H + h) * a.nc + ck) * P * N;
  for (int i = tid; i < P * N; i += kCcThreads) {
    const int p = i / N, j = i % N;
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += wk[k] * xs[k * P + p] * bs[k * NP + j];
    ws[i] = acc;
  }
}

// Pass 3 on the CUDA cores: y[t0.., h, :] for one (chunk, head, sequence).
template <typename T>
__global__ void __launch_bounds__(kCcThreads)
out_cc_kernel(Args a) {
  const int ck = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = ck * kQ, n = min(kQ, a.T - t0);
  const int P = a.P, N = a.N, NP = N + 1;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [kQ][P]
  float* bs = xs + kQ * P;          // [kQ][NP]
  float* cs = bs + kQ * NP;         // [kQ][NP]
  float* hs = cs + kQ * NP;         // [P][NP] h_in
  float* att = hs + P * NP;         // [kQ][kQ+1]
  float* dtp = att + kQ * (kQ + 1); // [kQ]
  float* cum = dtp + kQ;            // [kQ]

  const bool inter = ck > 0;
  const T* xb = static_cast<const T*>(a.x) + b * a.s.xb + t0 * a.s.xt +
                h * a.s.xh;
  const T* bb = static_cast<const T*>(a.b) + b * a.s.bb + t0 * a.s.bt;
  const T* cb = static_cast<const T*>(a.c) + b * a.s.cb + t0 * a.s.ct;
  for (int i = tid; i < kQ * P; i += kCcThreads) {
    const int k = i / P, p = i % P;
    xs[i] = k < n ? to_f(xb[k * a.s.xt + p]) : 0.f;
  }
  for (int i = tid; i < kQ * N; i += kCcThreads) {
    const int k = i / N, j = i % N;
    const bool ok = k < n;
    bs[k * NP + j] = ok ? to_f(bb[k * a.s.bt + j]) : 0.f;
    cs[k * NP + j] = ok ? to_f(cb[k * a.s.ct + j]) : 0.f;
  }
  if (inter) {
    const float* hin = a.ws + (((size_t)b * a.H + h) * a.nc + ck) * P * N;
    for (int i = tid; i < P * N; i += kCcThreads)
      hs[(i / N) * NP + i % N] = hin[i];
  }
  chunk_decay<T>(a, b, h, t0, n, dtp, cum);     // ends with a barrier
  for (int i = tid; i < kQ * kQ; i += kCcThreads) {
    const int q = i / kQ, k = i % kQ;
    float v = 0.f;
    if (k <= q) {                   // mask before exp: cum_q - cum_k <= 0
      const float* cr = cs + q * NP;
      const float* br = bs + k * NP;
      float dot = 0.f;
      for (int j = 0; j < N; ++j) dot += cr[j] * br[j];
      v = dot * expf(cum[q] - cum[k]) * dtp[k];
    }
    att[q * (kQ + 1) + k] = v;
  }
  __syncthreads();
  const float Dk = to_f(static_cast<const T*>(a.d_skip)[h]);
  T* yb = static_cast<T*>(a.y) + ((size_t)b * a.T * a.H + h) * P;
  for (int i = tid; i < n * P; i += kCcThreads) {
    const int q = i / P, p = i % P;
    const float* ar = att + q * (kQ + 1);
    float intra = 0.f;
    for (int k = 0; k <= q; ++k) intra += ar[k] * xs[k * P + p];
    float inter_v = 0.f;
    if (inter) {
      const float* cr = cs + q * NP;
      const float* sr = hs + p * NP;
      for (int j = 0; j < N; ++j) inter_v += cr[j] * sr[j];
    }
    store_f(intra + expf(cum[q]) * inter_v + Dk * xs[q * P + p],
            yb + (size_t)(t0 + q) * a.H * P + p);
  }
}

// ------------------------------------------------------------- pass 2

__device__ __forceinline__ float pass_step(float h, float d, float s) {
  return __fadd_rn(__fmul_rn(h, d), s);
}
__device__ __forceinline__ float4 pass_step(float4 h, float d, float4 s) {
  return make_float4(pass_step(h.x, d, s.x), pass_step(h.y, d, s.y),
                     pass_step(h.z, d, s.z), pass_step(h.w, d, s.w));
}

// One thread a state element, or four consecutive ones (V = float4), of
// (b, h): h_c = decay_c h_{c-1} + S_c over the chunks in order; the state
// entering chunk c > 0 replaces S_c. The chunks' S_c and decays are read
// kInFlight at a time before any store, so their latencies overlap.
template <typename V>
__global__ void __launch_bounds__(256)
state_pass_kernel(Args a) {
  const int PN = a.P * a.N / (int)(sizeof(V) / sizeof(float));  // V units
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B * a.H * PN) return;
  const int bh = i / PN, e = i % PN;
  V* w = reinterpret_cast<V*>(a.ws) + (size_t)bh * a.nc * PN + e;
  const float* dec = a.decay + (size_t)bh * a.nc;
  V hv = {};
  for (int c0 = 0; c0 < a.nc; c0 += kInFlight) {
    V sc[kInFlight];
    float dc[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int c = c0 + j;
      if (c < a.nc) {
        sc[j] = w[(size_t)c * PN];
        dc[j] = dec[c];
      }
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int c = c0 + j;
      if (c >= a.nc) continue;
      if (c > 0) w[(size_t)c * PN] = hv;
      hv = pass_step(hv, dc[j], sc[j]);
    }
  }
  reinterpret_cast<V*>(a.hout)[i] = hv;
}

// ------------------------------------------------------------- launch

size_t smem_tc_state(int N) {
  return (size_t)(2 * kQ * (kPT + 8) + kQ * (N + 8)) * 2 + 3 * kQ * 4;
}
size_t smem_tc_out(int N) {
  return (size_t)(2 * kQ * (N + 8) + kQ * (kPT + 8) + 2 * kPT * (N + 8)) * 2 +
         2 * kQ * 4;
}
size_t smem_cc_state(int P, int N) {
  return (size_t)(kQ * P + kQ * (N + 1) + 3 * kQ) * 4;
}
size_t smem_cc_out(int P, int N) {
  return (size_t)(kQ * P + 2 * kQ * (N + 1) + P * (N + 1) + kQ * (kQ + 1) +
                  2 * kQ) * 4;
}

template <typename K>
int launch_pass(K kernel, dim3 grid, int threads, size_t smem,
                const Args& a, cudaStream_t stream) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int state_pass(const Args& a, cudaStream_t stream) {
  const long long total = (long long)a.B * a.H * a.P * a.N;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((a.P * a.N) % 4 == 0) {       // float4 a thread (ws, hout aligned)
    state_pass_kernel<float4>
        <<<(unsigned)((total / 4 + 255) / 256), 256, 0, stream>>>(a);
  } else {
    state_pass_kernel<float>
        <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_cc(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.nc, a.H, a.B);
  int rc = launch_pass(state_cc_kernel<T>, grid, kCcThreads,
                       smem_cc_state(a.P, a.N), a, stream);
  if (rc != 0) return rc;
  rc = state_pass(a, stream);
  if (rc != 0) return rc;
  return launch_pass(out_cc_kernel<T>, grid, kCcThreads,
                     smem_cc_out(a.P, a.N), a, stream);
}

int run_tc(const Args& a, cudaStream_t stream) {
  if (a.P % kPT != 0 || a.N % 16 != 0 || a.N > kMaxNTc)
    return (int)cudaErrorInvalidValue;
  const long long gx = (long long)a.nc * (a.P / kPT);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, a.H, a.B);
  int rc = launch_pass(state_tc_kernel, grid, 128, smem_tc_state(a.N), a,
                       stream);
  if (rc != 0) return rc;
  rc = state_pass(a, stream);
  if (rc != 0) return rc;
  return launch_pass(out_tc_kernel, grid, 128, smem_tc_out(a.N), a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and the [H] parameters in
// one type); body: 0 = CUDA cores, 1 = tensor cores (bf16, P % 32 == 0,
// N % 16 == 0, N <= 128; kernels/ssd_scan.py `body` is the rule).
// strides: 9 element strides, x (b, t, h), dt (b, t), b (b, t), c (b, t);
// the last dimension of each is contiguous. vec: 1 when x, b and c and
// their (b, t) strides are 16-byte aligned. y is contiguous [B,T,H,P],
// hout contiguous [B,H,P,N] fp32; ws an fp32 workspace of
// B*H*ceil(T/64)*P*N floats and decay one of B*H*ceil(T/64). Returns a
// cudaError_t (0 = launched).
int ssd_scan(const void* x, const void* dt, const void* a_log,
             const void* d_skip, const void* dt_bias, const void* b,
             const void* c, void* y, void* hout, void* ws, void* decay,
             int B, int T, int H, int P, int N, const long long* strides,
             int vec, int dtype, int body, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || P <= 0 ||
      N <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides s{strides[0], strides[1], strides[2], strides[3], strides[4],
                  strides[5], strides[6], strides[7], strides[8]};
  const Args a{x, dt, a_log, d_skip, dt_bias, b, c, y,
               static_cast<float*>(hout), static_cast<float*>(ws),
               static_cast<float*>(decay), B, T, H, P, N, (T + kQ - 1) / kQ,
               vec, s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return run_tc(a, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run_cc<float>(a, st);
  if (dtype == 1) return run_cc<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
