// Blockwise flash attention for prompt prefill and for one prompt chunk,
// for Hopper (sm_90a). One kernel, two entry points.
//
// flash_prefill replaces the TPU kernel repro/kernels/flash_prefill.py ::
// flash_prefill_kernel (pallas_call at flash_prefill.py:87). Same
// contract: q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> out [B,S,Hq,hd]; query head
// h reads KV head h / (Hq/Hkv); the band mask of absolute positions keeps
// key kp for query qp when (not causal or qp - kp >= 0) and (no window or
// qp - kp < window); scale hd^-0.5; masked scores are -1e30; fp32 sums.
//
// flash_prefill_chunk replaces flash_prefill_chunk_kernel (pallas_call at
// flash_prefill.py:198, body _chunk_kernel at :111): q [B,C,Hq,hd] holds
// one prompt chunk whose row i sits at absolute position q_start[b] + i;
// k/v [B,S,Hkv,hd] is the whole KV buffer, key j at position j, taken
// through strides (the slot cache is [B,Hkv,S,hd] in memory; only the last
// dimension must be contiguous), so no copy of the buffer is made. Always
// causal, so stale data past the chunk end is masked. The block loads
// q_start[b] itself: the counterpart of the TPU's scalar prefetch.
//
// Unlike the TPU kernels both take any S and any C: the ragged last tiles
// are masked here. A row that sees no key at all writes 0.
//
// What bounds it on the card: arithmetic. A causal prefill does
// ~2*S*S*Hq*hd flops over 2*S*(Hq+2*Hkv)*hd elements moved; a chunk of C
// rows at offset q0 does ~4*C*(q0+C/2)*Hq*hd flops over the same K/V.
//
// Design. One block per (q tile, kv head, sequence). A q tile is 64 rows
// of the kv head's [C x g] row space taken position-major (row = pos*g +
// head-in-group), so all g query heads of a position share every K/V tile
// staged in shared memory, for any g. A loop over 32-key tiles takes the
// place of the TPU's sequential KV grid axis, from the first key any row of
// the tile may see (window) to the last (causal limit); tiles the band
// mask removes whole, such as the stale tail past the chunk, are never
// visited. Four threads own one row: its 8 scores of a key tile, its
// running max and sum (registers, reduced with warp shuffles) and a
// quarter of its fp32 numerator. Plain CUDA-core fp32 FMAs, no wgmma or
// TMA yet: correct first, fast in a later change.
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

// q/out contiguous [B,C,Hq,hd]; k/v [B,S,Hkv,hd] with element strides
// (batch, position, head) and a contiguous last dimension.
struct Args {
  const void* q; const void* k; const void* v; void* out;
  const int* q_start;              // [B] first query position; null = 0
  int B, C, S, Hq, Hkv;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;              // window <= 0: none
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const Args a) {
  constexpr int PER = HD / kTPR;   // numerator elements per thread
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = a.C, S = a.S, Hq = a.Hq;
  const int G = Hq / a.Hkv;
  const int causal = a.causal, window = a.window;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int q4 = tid % kTPR;
  const int q0 = a.q_start ? a.q_start[b] : 0;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kRows][HD+1]
  float* k_s = q_s + kRows * (HD + 1);     // [kKeys][HD+1]
  float* v_s = k_s + kKeys * (HD + 1);     // [kKeys][HD]
  float* p_s = v_s + kKeys * HD;           // [kRows][kKeys+1]

  const int rows_total = C * G;
  const int row0 = tile * kRows;
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int row = row0 + rr;
    float val = 0.f;
    if (row < rows_total) {
      const int pos = row / G, hg = row % G;
      val = to_f(q[(((size_t)b * C + pos) * Hq + (size_t)h * G + hg) * HD + d]);
    }
    q_s[rr * (HD + 1) + d] = val;
  }

  const int my_row = row0 + r;
  const bool row_ok = my_row < rows_total;
  const int my_pos = row_ok ? my_row / G : 0;      // row in the chunk
  const int my_qp = q0 + my_pos;                   // its absolute position
  const int pos_lo = q0 + row0 / G;
  const int pos_hi = q0 + min(C - 1, (row0 + kRows - 1) / G);
  const int k_hi = causal ? min(S - 1, pos_hi) : S - 1;
  const int k_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const T* kb = k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vb = v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;

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
        kv = to_f(kb[(size_t)kpos * a.k_ss + d]);
        vv = to_f(vb[(size_t)kpos * a.v_ss + d]);
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
      const int dd = my_qp - kpos;
      const bool kp = row_ok && kpos < S && (!causal || dd >= 0) &&
                      (window <= 0 || dd < window);
      sc[i] = kp ? sc[i] * a.scale : kNegInf;
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
    T* o = out + (((size_t)b * C + my_pos) * Hq + (size_t)h * G + hg) * HD;
#pragma unroll
    for (int i = 0; i < PER; ++i) store_f(acc[i] / den, o + q4 + kTPR * i);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(kRows * (HD + 1) + kKeys * (HD + 1) +
                               kKeys * HD + kRows * (kKeys + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows = (long long)a.C * (a.Hq / a.Hkv);
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), a.Hkv, a.B);
  flash_prefill_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    case 256: return launch<T, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const Args& a, int hd, int dtype, void* stream) {
  if (a.B <= 0 || a.C <= 0 || a.S <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, a, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Whole-prompt prefill, all of q/k/v/out contiguous. dtype: 0 = float32,
// 1 = bfloat16; window <= 0 means no window. Returns a cudaError_t
// (0 = launched).
int flash_prefill(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int Hq, int Hkv, int hd, int causal,
                  int window, float scale, int dtype, void* stream) {
  const long long ss = (long long)Hkv * hd, sb = ss * S;
  Args a{q, k, v, out, nullptr, B, S, S, Hq, Hkv,
         sb, ss, hd, sb, ss, hd, causal, window, scale};
  return run(a, hd, dtype, stream);
}

// One causal prompt chunk: q/out contiguous [B,C,Hq,hd], q_start [B]
// int32 on the device, k/v [B,S,Hkv,hd] given by element strides
// (batch, position, head), last dimension contiguous.
int flash_prefill_chunk(const void* q, const void* k, const void* v,
                        void* out, const void* q_start, int B, int C, int S,
                        int Hq, int Hkv, int hd, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, int window,
                        float scale, int dtype, void* stream) {
  Args a{q, k, v, out, static_cast<const int*>(q_start), B, C, S, Hq, Hkv,
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 1, window, scale};
  return run(a, hd, dtype, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
