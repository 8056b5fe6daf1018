// Blockwise flash attention for prompt prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_prefill.py ::
// flash_prefill_kernel (pallas_call at flash_prefill.py:87). Same
// contract: q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> out [B,S,Hq,hd]; query head
// h reads KV head h / (Hq/Hkv); the band mask of absolute positions keeps
// key kp for query qp when (not causal or qp - kp >= 0) and (no window or
// qp - kp < window); scale hd^-0.5; masked scores are -1e30; fp32 sums.
// Unlike the TPU kernel it takes any S: the ragged last tiles are masked
// here, because the engine prefills each prompt at its exact length.
//
// What bounds it on the card: arithmetic. A causal prefill does
// ~2*S*S*Hq*hd flops over 2*S*(Hq+2*Hkv)*hd elements moved.
//
// Design. One block per (q tile, kv head, sequence). A q tile is 64 rows
// of the kv head's [S x g] row space taken position-major (row = pos*g +
// head-in-group), so all g query heads of a position share every K/V tile
// staged in shared memory, for any g. A loop over 32-key tiles takes the
// place of the TPU's sequential KV grid axis, from the first key any row of
// the tile may see (window) to the last (causal limit); tiles the band
// mask removes whole are never visited. Four threads own one row: its 8
// scores of a key tile, its running max and sum (registers, reduced with
// warp shuffles) and a quarter of its fp32 numerator. Plain CUDA-core
// fp32 FMAs, no wgmma or TMA yet: correct first, fast in a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;          // query rows per block
constexpr int kKeys = 32;          // keys per tile
constexpr int kTPR = 4;            // threads per row
constexpr int kThreads = kRows * kTPR;
constexpr int kCols = kKeys / kTPR;  // scores per thread per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int PER = HD / kTPR;   // numerator elements per thread
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int q4 = tid % kTPR;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kRows][HD+1]
  float* k_s = q_s + kRows * (HD + 1);     // [kKeys][HD+1]
  float* v_s = k_s + kKeys * (HD + 1);     // [kKeys][HD]
  float* p_s = v_s + kKeys * HD;           // [kRows][kKeys+1]

  const int rows_total = S * G;
  const int row0 = tile * kRows;
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int row = row0 + rr;
    float val = 0.f;
    if (row < rows_total) {
      const int pos = row / G, hg = row % G;
      val = to_f(q[(((size_t)b * S + pos) * Hq + (size_t)h * G + hg) * HD + d]);
    }
    q_s[rr * (HD + 1) + d] = val;
  }

  const int my_row = row0 + r;
  const bool row_ok = my_row < rows_total;
  const int my_pos = row_ok ? my_row / G : 0;
  const int pos_lo = row0 / G;
  const int pos_hi = min(S - 1, (row0 + kRows - 1) / G);
  const int k_hi = causal ? pos_hi : S - 1;
  const int k_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;

  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int kt = (k_lo / kKeys) * kKeys; kt <= k_hi; kt += kKeys) {
    __syncthreads();               // q_s loaded / previous tile consumed
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const int kpos = kt + t;
      float kv = 0.f, vv = 0.f;
      if (kpos < S) {
        const size_t off = (((size_t)b * S + kpos) * Hkv + h) * HD + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      k_s[t * (HD + 1) + d] = kv;
      v_s[t * HD + d] = vv;
    }
    __syncthreads();

    float sc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) sc[i] = 0.f;
    const float* qr = q_s + r * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int i = 0; i < kCols; ++i) sc[i] += qv * k_s[(q4 + kTPR * i) * (HD + 1) + d];
    }
    unsigned keep = 0;
    float mloc = kNegInf;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int kpos = kt + q4 + kTPR * i;
      const int dd = my_pos - kpos;
      const bool kp = row_ok && kpos < S && (!causal || dd >= 0) &&
                      (window <= 0 || dd < window);
      sc[i] = kp ? sc[i] * scale : kNegInf;
      keep |= (unsigned)kp << i;
      mloc = fmaxf(mloc, sc[i]);
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
    const float m_new = fmaxf(m, mloc);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float p = ((keep >> i) & 1u) ? expf(sc[i] - m_new) : 0.f;
      p_s[r * (kKeys + 1) + q4 + kTPR * i] = p;
      lsum += p;
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(kFull, lsum, o);
    const float corr = expf(m - m_new);
    l = l * corr + lsum;
    m = m_new;
    __syncwarp();                  // the row's probabilities, from its 4 lanes
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= corr;
    const float* pr = p_s + r * (kKeys + 1);
    for (int c = 0; c < kKeys; ++c) {
      const float p = pr[c];
      const float* vr = v_s + c * HD + q4;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] += p * vr[kTPR * i];
    }
  }

  if (row_ok) {
    const int hg = my_row % G;
    const float den = fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * S + my_pos) * Hq + (size_t)h * G + hg) * HD;
#pragma unroll
    for (int i = 0; i < PER; ++i) store_f(acc[i] / den, o + q4 + kTPR * i);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = (size_t)(kRows * (HD + 1) + kKeys * (HD + 1) +
                               kKeys * HD + kRows * (kKeys + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows = (long long)S * G;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), Hkv, B);
  flash_prefill_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                int B, int S, int Hq, int Hkv, int causal, int window,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Hq, Hkv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window.
// Returns a cudaError_t (0 = launched).
int flash_prefill(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int Hq, int Hkv, int hd, int causal,
                  int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, S, Hq, Hkv, causal, window,
                              scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, Hq, Hkv, causal,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
