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
// What bounds it on the card: at Mamba2 widths (P 64, N 128, chunk 64) a
// (b, h) pair does ~1.4M multiply-adds per chunk on ~25 KB of input, so
// the bound is the operation count (about 1.5 us for a 256-token prompt
// of mamba2-780m), far below what this first kernel reaches.
//
// Design. One block per (head, sequence) walks the chunks in order with
// the [P,N] fp32 state in shared memory: the TPU grid's sequential carry
// over chunks (ssd_scan.py:24-68) becomes a loop inside the block. Each
// chunk's x, B, C, dt and their cumulative decay are staged in shared
// memory (about 130 KB at Mamba2 widths, above the 48 KB default, hence
// the opt-in), then three passes: the [Q,Q] masked scores
// (C_q . B_k) exp(cum_q - cum_k) dt_k, masked BEFORE exp as ssm.py warns;
// y from the scores, the incoming state and the skip term; the state
// update. Rows are padded by one float so the strided shared-memory reads
// fall in distinct banks. Plain CUDA cores, no tensor cores. The grid has
// B*H blocks (48 for one mamba2-780m prompt on 132 SMs), so it is
// under-filled: the chunk-parallel two-pass form (ssd_scan.py:4-7) is the
// later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;              // chunk length
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dtr,
                const T* __restrict__ a_log, const T* __restrict__ d_skip,
                const T* __restrict__ dt_bias, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ hout, int Tn, int H, int P, int N,
                Strides s) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int NP = N + 1;             // padded row of the N-wide tiles

  extern __shared__ float smem[];
  float* st = smem;                 // [P][NP] running state
  float* xs = st + P * NP;          // [Q][P]
  float* bs = xs + kQ * P;          // [Q][NP]
  float* cs = bs + kQ * NP;         // [Q][NP]
  float* att = cs + kQ * NP;        // [Q][Q+1] masked scores times dt_k
  float* dtp = att + kQ * (kQ + 1); // [Q] softplus(dt + bias), 0 past T
  float* cum = dtp + kQ;            // [Q] inclusive cumsum of dt*A
  float* wk = cum + kQ;             // [Q] dt_k exp(cum_last - cum_k)

  const float A = -expf(to_f(a_log[h]));
  const float Dk = to_f(d_skip[h]);
  const float bias = to_f(dt_bias[h]);
  for (int i = tid; i < P * NP; i += kThreads) st[i] = 0.f;

  const T* xb = x + b * s.xb + h * s.xh;
  const T* db = dtr + b * s.db + h;
  const T* bb = bm + b * s.bb;
  const T* cb = cm + b * s.cb;
  T* yb = y + ((size_t)b * Tn * H + h) * P;

  for (int t0 = 0; t0 < Tn; t0 += kQ) {
    const int n = min(kQ, Tn - t0);
    if (tid < kQ)
      dtp[tid] = tid < n ? softplus(to_f(db[(t0 + tid) * s.dt]) + bias) : 0.f;
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[i] = t < n ? to_f(xb[(t0 + t) * s.xt + p]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int t = i / N, j = i % N;
      const bool ok = t < n;
      bs[t * NP + j] = ok ? to_f(bb[(t0 + t) * s.bt + j]) : 0.f;
      cs[t * NP + j] = ok ? to_f(cb[(t0 + t) * s.ct + j]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                 // 64 adds in order, as a cumsum
      float acc = 0.f;
      for (int t = 0; t < kQ; ++t) {
        acc += dtp[t] * A;
        cum[t] = acc;
      }
    }
    __syncthreads();
    const float cl = cum[kQ - 1];
    if (tid < kQ) wk[tid] = dtp[tid] * expf(cl - cum[tid]);
    for (int i = tid; i < kQ * kQ; i += kThreads) {
      const int q = i / kQ, k = i % kQ;
      float v = 0.f;
      if (k <= q) {                 // mask before exp: cum_q - cum_k <= 0
        const float* cr = cs + q * NP;
        const float* br = bs + k * NP;
        float dot = 0.f;
        for (int j = 0; j < N; ++j) dot += cr[j] * br[j];
        v = dot * expf(cum[q] - cum[k]) * dtp[k];
      }
      att[q * (kQ + 1) + k] = v;
    }
    __syncthreads();
    // y_q = sum_k att[q][k] x_k + exp(cum_q) C_q . h_prev + D x_q
    for (int i = tid; i < n * P; i += kThreads) {
      const int q = i / P, p = i % P;
      const float* ar = att + q * (kQ + 1);
      float intra = 0.f;
      for (int k = 0; k <= q; ++k) intra += ar[k] * xs[k * P + p];
      const float* cr = cs + q * NP;
      const float* sr = st + p * NP;
      float inter = 0.f;
      for (int j = 0; j < N; ++j) inter += cr[j] * sr[j];
      store_f(intra + expf(cum[q]) * inter + Dk * xs[q * P + p],
              yb + (size_t)(t0 + q) * H * P + p);
    }
    __syncthreads();                // every read of the old state is done
    // h' = exp(cum_last) h + sum_k wk[k] x_k B_k^T
    const float decay = expf(cl);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, j = i % N;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc += wk[k] * xs[k * P + p] * bs[k * NP + j];
      st[p * NP + j] = decay * st[p * NP + j] + acc;
    }
    __syncthreads();
  }
  float* hb = hout + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) hb[i] = st[(i / N) * NP + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log,
           const void* d_skip, const void* dt_bias, const void* bm,
           const void* cm, void* y, float* hout, int B, int Tn, int H, int P,
           int N, const Strides& s, cudaStream_t stream) {
  const size_t smem = (size_t)(P * (N + 1) + kQ * P + 2 * kQ * (N + 1) +
                               kQ * (kQ + 1) + 3 * kQ) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(a_log), static_cast<const T*>(d_skip),
      static_cast<const T*>(dt_bias), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), hout, Tn, H, P, N, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and the [H] parameters in
// one type). strides: 9 element strides, x (b, t, h), dt (b, t), b (b, t),
// c (b, t); the last dimension of each is contiguous. y is contiguous
// [B,T,H,P], hout contiguous [B,H,P,N] fp32. Returns a cudaError_t
// (0 = launched).
int ssd_scan(const void* x, const void* dt, const void* a_log,
             const void* d_skip, const void* dt_bias, const void* b,
             const void* c, void* y, void* hout, int B, int T, int H, int P,
             int N, const long long* strides, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  Strides s{strides[0], strides[1], strides[2], strides[3], strides[4],
            strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(hout);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, d_skip, dt_bias, b, c, y, h, B, T, H,
                         P, N, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_log, d_skip, dt_bias, b, c, y, h,
                                 B, T, H, P, N, s, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
