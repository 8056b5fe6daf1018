// GQA flash-decode over a slot (ring-buffer) KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py ::
// decode_attention_kernel (pallas_call at decode_attention.py:80). Same
// contract: q [B,Hq,hd], k/v [B,Hkv,S,hd], kv_pos [B,S] int32 (absolute
// position per slot, -1 = empty), q_pos [B] int32 -> out [B,Hq,hd]; query
// head h reads KV head h / (Hq/Hkv); slot s is kept when
// 0 <= kv_pos <= q_pos and (no window or q_pos - kv_pos < window); scale
// hd^-0.5; masked scores are -1e30; sums in fp32. A row with nothing live
// (an empty or inactive slot) writes 0, as the TPU kernel does. Unlike the
// TPU wrapper it takes any S: the ragged last tile is masked here.
//
// What bounds it on the card: device-memory bytes. Each (sequence, KV
// head) reads the K and V of its live slots once and does 4*g flops per
// element read, far below the H100's ~295 flops/byte balance point.
//
// Design. One block per (kv head, sequence) holding all g query rows of
// the group, so each K/V slot is read once for the g heads that share it.
// A loop over 64-slot tiles inside the block takes the place of the TPU's
// sequential KV grid axis, with the online-softmax state in registers
// (running max and sum per row, the fp32 numerator spread over the row's
// 16 threads). A ring cache is in slot order, not position order, so the
// loop cannot stop at q_pos as the paged kernel does; instead each tile
// first reads its kv_pos and works out which slots the mask keeps. A tile
// with none is skipped whole (one block vote), and only kept slots' K/V
// rows are read, so an append-only cache that is mostly empty costs only
// its kv_pos. Plain CUDA cores, no wgmma or TMA, one block per (sequence,
// KV head) with no split over S yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTPR = 16;            // threads per query row
constexpr int kTile = 64;           // slots per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, int HD>
__global__ void decode_attention_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const int* __restrict__ kv_pos,
                                        const int* __restrict__ q_pos,
                                        T* __restrict__ out, int Hq, int Hkv,
                                        int S, int window, float scale) {
  constexpr int PER = HD / kTPR;    // numerator elements per thread
  const int h = blockIdx.x;         // kv head
  const int b = blockIdx.y;         // sequence
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r = tid / kTPR;         // query row of the group (>= G: idle)
  const int lane = tid % kTPR;
  const bool live_row = r < G;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [G][HD]
  float* k_s = q_s + G * HD;               // [kTile][HD+1]
  float* v_s = k_s + kTile * (HD + 1);     // [kTile][HD]
  float* p_s = v_s + kTile * HD;           // [G][kTile]
  int* keep_s = reinterpret_cast<int*>(p_s + G * kTile);   // [kTile]

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * HD;
  for (int i = tid; i < G * HD; i += nthreads) q_s[i] = to_f(qb[i]);

  const int qp = q_pos[b];
  const int* pos_b = kv_pos + (size_t)b * S;
  const size_t base = ((size_t)b * Hkv + h) * (size_t)S * HD;

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = min(kTile, S - t0);
    int any = 0;
    for (int i = tid; i < kTile; i += nthreads) {
      const int p = i < n ? pos_b[t0 + i] : -1;
      const int kp = p >= 0 && p <= qp && (window <= 0 || qp - p < window);
      keep_s[i] = kp;
      any |= kp;
    }
    // barrier and vote: keep_s is visible, and q_s on the first pass
    if (!__syncthreads_or(any)) continue;
    for (int i = tid; i < n * HD; i += nthreads) {
      const int t = i / HD, d = i % HD;
      float kv = 0.f, vv = 0.f;
      if (keep_s[t]) {
        kv = to_f(k[base + (size_t)t0 * HD + i]);
        vv = to_f(v[base + (size_t)t0 * HD + i]);
      }
      k_s[t * (HD + 1) + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    float mloc = kNegInf;
    if (live_row) {
      const float* qr = q_s + r * HD;
      for (int c = lane; c < n; c += kTPR) {
        const float* kr = k_s + c * (HD + 1);
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
        s = keep_s[c] ? s * scale : kNegInf;
        p_s[r * kTile + c] = s;
        mloc = fmaxf(mloc, s);
      }
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
    const float m_new = fmaxf(m, mloc);
    float lsum = 0.f;
    if (live_row) {
      for (int c = lane; c < n; c += kTPR) {
        const float p = keep_s[c] ? expf(p_s[r * kTile + c] - m_new) : 0.f;
        p_s[r * kTile + c] = p;
        lsum += p;
      }
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(kFull, lsum, o);
    const float corr = expf(m - m_new);
    l = l * corr + lsum;
    m = m_new;
    __syncwarp();                   // the row's probabilities, from its 16 lanes
    if (live_row) {
      const float* pr = p_s + r * kTile;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int d = lane + kTPR * j;
        float a = acc[j] * corr;
        for (int c = 0; c < n; ++c) a += pr[c] * v_s[c * HD + d];
        acc[j] = a;
      }
    }
    __syncthreads();                // before the next tile overwrites smem
  }

  if (live_row) {
    const float den = fmaxf(l, 1e-30f);
    T* ob = out + ((size_t)b * Hq + (size_t)h * G + r) * HD;
#pragma unroll
    for (int j = 0; j < PER; ++j) store_f(acc[j] / den, ob + lane + kTPR * j);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* kv_pos,
           const int* q_pos, void* out, int B, int Hq, int Hkv, int S,
           int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int threads = ((G * kTPR + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(G * HD + kTile * (HD + 1) + kTile * HD +
                               G * kTile) * sizeof(float) + kTile * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  decode_attention_kernel<T, HD><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, q_pos, static_cast<T*>(out), Hq, Hkv,
      S, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* kp, const int* qp, void* out, int B, int Hq,
                int Hkv, int S, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, kp, qp, out, B, Hq, Hkv, S, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, kp, qp, out, B, Hq, Hkv, S, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, kp, qp, out, B, Hq, Hkv, S, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, kp, qp, out, B, Hq, Hkv, S, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window. All
// tensors contiguous. Returns a cudaError_t (0 = launched).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_pos, const void* q_pos, void* out, int B,
                     int Hq, int Hkv, int hd, int S, int window, float scale,
                     int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kp, qp, out, B, Hq, Hkv, S, window,
                              scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kp, qp, out, B, Hq, Hkv, S,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
