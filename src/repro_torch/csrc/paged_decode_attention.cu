// GQA flash-decode over the paged KV arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py ::
// paged_decode_attention_kernel (pallas_call at paged_attention.py:201).
// Same contract: q [B,Hq,hd], k/v pages [P,Hkv,psz,hd], page_table
// [B,maxp] int32 (-1 = unused), q_pos [B] int32 -> out [B,Hq,hd]; query
// head h reads KV head h / (Hq/Hkv); keys at logical positions 0..q_pos[b]
// are kept; scale hd^-0.5; masked scores are -1e30; sums in fp32.
//
// What bounds it on the card: device-memory bytes. Each (sequence, KV
// head) reads the K and V of its live tokens once and does 4*g flops per
// element read, far below the H100's ~295 flops/byte balance point.
//
// Design. One block per (kv head, sequence) with the g query rows of the
// group, so each K/V page is read once for all g heads that share it.
// The TPU walks the page axis as a sequential grid dimension with the
// online-softmax state in VMEM scratch; here a loop inside the block walks
// the page table and keeps that state in registers (running max and sum
// per row, the fp32 numerator spread over the row's 16 threads). The loop
// stops at the page holding q_pos: later pages are masked whole, so
// skipping them changes nothing. A -1 entry is skipped, which is what the
// TPU's "read page 0 and mask" amounts to. A row with nothing live (pad
// rows) ends with sum 0 and writes 0, as the TPU kernel does. Each page is
// staged once in shared memory as fp32 (K rows padded by one word against
// bank conflicts). Plain CUDA cores, no wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTPR = 16;            // threads per query row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ q_pos,
                                    T* __restrict__ out,
                                    int Hq, int Hkv, int psz, int maxp,
                                    float scale) {
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
  float* k_s = q_s + G * HD;               // [psz][HD+1]
  float* v_s = k_s + psz * (HD + 1);       // [psz][HD]
  float* p_s = v_s + psz * HD;             // [G][psz]

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * HD;
  for (int i = tid; i < G * HD; i += nthreads) q_s[i] = to_f(qb[i]);

  const int qp = q_pos[b];
  int npages = qp >= 0 ? qp / psz + 1 : 0;
  if (npages > maxp) npages = maxp;

  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
  float m = kNegInf, l = 0.f;
  __syncthreads();

  for (int j = 0; j < npages; ++j) {
    const int page = page_table[(size_t)b * maxp + j];   // block-uniform
    if (page < 0) continue;
    const size_t base = ((size_t)page * Hkv + h) * (size_t)psz * HD;
    for (int i = tid; i < psz * HD; i += nthreads) {
      const int t = i / HD, d = i % HD;
      k_s[t * (HD + 1) + d] = to_f(k_pages[base + i]);
      v_s[i] = to_f(v_pages[base + i]);
    }
    __syncthreads();

    float mloc = kNegInf;
    if (live_row) {
      const float* qr = q_s + r * HD;
      for (int c = lane; c < psz; c += kTPR) {
        const float* kr = k_s + c * (HD + 1);
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
        s *= scale;
        s = (j * psz + c <= qp) ? s : kNegInf;
        p_s[r * psz + c] = s;
        mloc = fmaxf(mloc, s);
      }
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
    const float m_new = fmaxf(m, mloc);
    float lsum = 0.f;
    if (live_row) {
      for (int c = lane; c < psz; c += kTPR) {
        const float p = (j * psz + c <= qp) ? expf(p_s[r * psz + c] - m_new) : 0.f;
        p_s[r * psz + c] = p;
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
      const float* pr = p_s + r * psz;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int d = lane + kTPR * k;
        float a = acc[k] * corr;
        for (int c = 0; c < psz; ++c) a += pr[c] * v_s[c * HD + d];
        acc[k] = a;
      }
    }
    __syncthreads();                // before the next page overwrites k_s/v_s
  }

  if (live_row) {
    const float den = fmaxf(l, 1e-30f);
    T* ob = out + ((size_t)b * Hq + (size_t)h * G + r) * HD;
#pragma unroll
    for (int k = 0; k < PER; ++k) store_f(acc[k] / den, ob + lane + kTPR * k);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_table, const int* q_pos, void* out, int B, int Hq,
           int Hkv, int psz, int maxp, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int threads = ((G * kTPR + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      (size_t)(G * HD + psz * (HD + 1) + psz * HD + G * psz) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, HD><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, q_pos, static_cast<T*>(out),
      Hq, Hkv, psz, maxp, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* pt, const int* qp, void* out, int B, int Hq,
                int Hkv, int psz, int maxp, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, pt, qp, out, B, Hq, Hkv, psz, maxp, scale, s);
    case 64: return launch<T, 64>(q, k, v, pt, qp, out, B, Hq, Hkv, psz, maxp, scale, s);
    case 128: return launch<T, 128>(q, k, v, pt, qp, out, B, Hq, Hkv, psz, maxp, scale, s);
    case 256: return launch<T, 256>(q, k, v, pt, qp, out, B, Hq, Hkv, psz, maxp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* q_pos, void* out, int B, int Hq,
                           int Hkv, int hd, int psz, int maxp, float scale,
                           int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || psz <= 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, pt, qp, out, B, Hq, Hkv,
                              psz, maxp, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, pt, qp, out, B,
                                      Hq, Hkv, psz, maxp, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
