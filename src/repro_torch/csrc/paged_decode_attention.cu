// GQA flash attention over the paged KV arena, for Hopper (sm_90a): one
// decode query per sequence (entry paged_decode_attention) or a window of C
// verify queries per sequence (entry paged_verify_attention).
//
// Replaces the TPU kernels repro/kernels/paged_attention.py ::
// paged_decode_attention_kernel (pallas_call at paged_attention.py:201) and
// paged_verify_attention_kernel (pallas_call at :159). Contract: q
// [B,C,Hq,hd] (decode: C = 1, q [B,Hq,hd]), k/v pages [P,Hkv,psz,hd],
// page_table [B,maxp] int32 (-1 = unused), q_start [B] int32 -> out
// [B,C,Hq,hd]; query head h reads KV head h / (Hq/Hkv); query c of row b
// keeps keys at logical positions 0..q_start[b]+c (the causal staircase of a
// verify window; decode passes q_start = q_pos); scale hd^-0.5; masked
// scores are -1e30; sums in fp32.
//
// What bounds it on the card: device-memory bytes. Each (sequence, KV
// head) reads the K and V of its live tokens once and does 4*C*g flops per
// element read (g = Hq/Hkv), far below the H100's ~295 flops/byte balance
// point for C*g <= 80.
//
// Design. The R = C*g query rows that share one KV head go to one block
// per (kv head, sequence), so each K/V page is read once for all of them;
// row r is query c = r / g of head h*g + r % g, read from q's [B,C,Hq,hd]
// layout by index arithmetic (no transposed copy). A row takes 16 threads,
// so a block holds at most 64 rows: a larger R (C = 5 at g = 16 gives 80)
// is cut into equal row tiles over gridDim.z, each walking the pages again
// (the second walk mostly hits L2). The TPU walks the page axis as a
// sequential grid dimension with the online-softmax state in VMEM scratch;
// here a loop inside the block walks the page table and keeps that state in
// registers (running max and sum per row, the fp32 numerator spread over
// the row's 16 threads). The loop stops at the page holding the tile's last
// query position: later pages are masked whole for every row of the tile.
// Within a page each row masks by its own position. A -1 entry is skipped,
// which is what the TPU's "read page 0 and mask" amounts to. A row with
// nothing live (pad rows, whose table is all -1) ends with sum 0 and writes
// 0, as the TPU kernel's acc / max(l, 1e-30) does. Each page is staged once
// in shared memory as fp32 (K rows padded by one word against bank
// conflicts). Plain CUDA cores, no wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTPR = 16;            // threads per query row
constexpr int kMaxRows = 1024 / kTPR;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, int HD>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_pages,
                                       const T* __restrict__ v_pages,
                                       const int* __restrict__ page_table,
                                       const int* __restrict__ q_start,
                                       T* __restrict__ out,
                                       int C, int Hq, int Hkv, int psz,
                                       int maxp, int rows_per_tile,
                                       float scale) {
  constexpr int PER = HD / kTPR;    // numerator elements per thread
  const int h = blockIdx.x;         // kv head
  const int b = blockIdx.y;         // sequence
  const int G = Hq / Hkv;
  const int R = C * G;              // query rows sharing this kv head
  const int r0 = blockIdx.z * rows_per_tile;
  const int nrows = min(rows_per_tile, R - r0);   // rows of this tile
  if (nrows <= 0) return;                         // block-uniform
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lr = tid / kTPR;        // row of the tile (>= nrows: idle)
  const int lane = tid % kTPR;
  const bool live_row = lr < nrows;
  const int r = r0 + lr;

  extern __shared__ float smem[];
  float* q_s = smem;                            // [rows][HD]
  float* k_s = q_s + rows_per_tile * HD;        // [psz][HD+1]
  float* v_s = k_s + psz * (HD + 1);            // [psz][HD]
  float* p_s = v_s + psz * HD;                  // [rows][psz]

  // row i of the tile is query c = (r0+i) / G of head h*G + (r0+i) % G
  for (int i = tid; i < nrows * HD; i += nthreads) {
    const int rr = r0 + i / HD, d = i % HD;
    const size_t src =
        (((size_t)b * C + rr / G) * Hq + (size_t)h * G + rr % G) * HD + d;
    q_s[i] = to_f(q[src]);
  }

  const int qs = q_start[b];
  const int row_pos = qs + r / G;               // this row's query position
  const int last_pos = qs + (r0 + nrows - 1) / G;
  int npages = last_pos >= 0 ? last_pos / psz + 1 : 0;
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
      const float* qr = q_s + lr * HD;
      for (int c = lane; c < psz; c += kTPR) {
        const float* kr = k_s + c * (HD + 1);
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
        s *= scale;
        s = (j * psz + c <= row_pos) ? s : kNegInf;
        p_s[lr * psz + c] = s;
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
        const float p =
            (j * psz + c <= row_pos) ? expf(p_s[lr * psz + c] - m_new) : 0.f;
        p_s[lr * psz + c] = p;
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
      const float* pr = p_s + lr * psz;
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
    T* ob = out + (((size_t)b * C + r / G) * Hq + (size_t)h * G + r % G) * HD;
#pragma unroll
    for (int k = 0; k < PER; ++k) store_f(acc[k] / den, ob + lane + kTPR * k);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_table, const int* q_start, void* out, int B, int C,
           int Hq, int Hkv, int psz, int maxp, float scale,
           cudaStream_t stream) {
  const int R = C * (Hq / Hkv);
  const int tiles = (R + kMaxRows - 1) / kMaxRows;
  const int rows = (R + tiles - 1) / tiles;     // equal tiles of <= 64 rows
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = ((rows * kTPR + 31) / 32) * 32;
  const size_t smem =
      (size_t)(rows * HD + psz * (HD + 1) + psz * HD + rows * psz) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B, tiles);
  paged_attention_kernel<T, HD><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, q_start,
      static_cast<T*>(out), C, Hq, Hkv, psz, maxp, rows, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* pt, const int* qs, void* out, int B, int C, int Hq,
                int Hkv, int psz, int maxp, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, pt, qs, out, B, C, Hq, Hkv, psz, maxp, scale, s);
    case 64: return launch<T, 64>(q, k, v, pt, qs, out, B, C, Hq, Hkv, psz, maxp, scale, s);
    case 128: return launch<T, 128>(q, k, v, pt, qs, out, B, C, Hq, Hkv, psz, maxp, scale, s);
    case 256: return launch<T, 256>(q, k, v, pt, qs, out, B, C, Hq, Hkv, psz, maxp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k_pages, const void* v_pages,
        const void* page_table, const void* q_start, void* out, int B, int C,
        int Hq, int Hkv, int hd, int psz, int maxp, float scale, int dtype,
        void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || psz <= 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* qs = static_cast<const int*>(q_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, pt, qs, out, B, C, Hq,
                              Hkv, psz, maxp, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, pt, qs, out, B,
                                      C, Hq, Hkv, psz, maxp, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* q_pos, void* out, int B, int Hq,
                           int Hkv, int hd, int psz, int maxp, float scale,
                           int dtype, void* stream) {
  return run(q, k_pages, v_pages, page_table, q_pos, out, B, 1, Hq, Hkv, hd,
             psz, maxp, scale, dtype, stream);
}

int paged_verify_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* q_start, void* out, int B, int C,
                           int Hq, int Hkv, int hd, int psz, int maxp,
                           float scale, int dtype, void* stream) {
  return run(q, k_pages, v_pages, page_table, q_start, out, B, C, Hq, Hkv, hd,
             psz, maxp, scale, dtype, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
