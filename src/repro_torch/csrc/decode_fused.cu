// The paged decode step's elementwise chain between its matrix products,
// fused, for Hopper (sm_90a): residual add + RMSNorm, RoPE + the new
// token's K/V page write, and the gated MLP's silu(g) * u.
//
// Replaces no TPU kernel. The JAX package leaves the norm, the rotation
// and the activation to XLA, which fuses each chain into the loops around
// it (repro/models/layers.py: rms_norm, apply_rope, gated_mlp). In the
// port's plain PyTorch each op is a kernel of its own: ~70 a layer at
// edge-6b (casts, squares, means, the frequency table rebuilt on every
// call, cos, sin, cat, two index_put_ writes), each a node of the
// captured decode graph.
//
// What bounds it on the card: launch latency, not bytes. At <= 32 rows a
// kernel of the chain reads and writes at most a few hundred KB (~0.1 us
// at 3.35 TB/s), while a kernel node of a captured graph costs a couple of
// microseconds to launch and drain. Design: one kernel per chain, one
// pass over the data, 16-byte vector loads and stores, fp32 math in
// registers (and the row's cos/sin table in shared memory), no
// intermediate in device memory.
//
// Same arithmetic as the plain path (kernels/ref.py), rounding point for
// rounding point, with the products and sums written as __fmul_rn /
// __fadd_rn so that nvcc contracts none of them into an FMA. What may
// still differ: the order of the fp32 sum of squares, rsqrtf (the one
// PyTorch's CUDA rsqrt calls) and sincosf against the CPU's libm; the
// tests hold the outputs to one ulp of their type.
//
// add_rms_norm (one block a row):
//   x <- T(x + delta) in place (delta null: x unchanged), then
//   h  = T(fp32(x) * rsqrt(sum(fp32(x)^2) * (1/D) + eps) * (1 + fp32(w)))
// rope_kv_write (one block a row b, every head of q, k and v):
//   ang_i = float(q_pos[b]) * freqs[i] (precise sincosf: angles reach
//   ~10^3 rad at max_seq 1024), half-split rotation in fp32:
//   out[i] = x1 cos - x2 sin, out[i + hd/2] = x2 cos + x1 sin;
//   q_out <- T(rotated q); k_pages[w_page[b], h, w_off[b], :] <- T(rotated
//   k); v_pages[...] <- v. Rows meant for the spare page write it.
// silu_mul (elementwise): out = T(T(g / (1 + exp(-g))) * u).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// elements of T in 16 bytes
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

// 16 bytes at p (16-byte aligned) as fp32 values
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* o) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// fp32 values rounded to T (to nearest even), 16 bytes stored at p
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// v rounded to T and back: a rounding point of the plain path
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the sum of v over the block (blockDim.x a multiple of 32, <= 1024),
// given to every thread
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
add_rms_norm_kernel(T* __restrict__ x, const T* __restrict__ delta,
                    const T* __restrict__ w, T* __restrict__ h, int D,
                    float eps) {
  constexpr int N = Vec<T>::N;
  const size_t row = (size_t)blockIdx.x * D;
  T* xr = x + row;
  T* hr = h + row;
  const int step = blockDim.x * N;
  float ss = 0.f;
  for (int c = threadIdx.x * N; c < D; c += step) {
    float a[N];
    load16(xr + c, a);
    if (delta != nullptr) {
      float d[N];
      load16(delta + row + c, d);
#pragma unroll
      for (int e = 0; e < N; ++e) a[e] = rnd<T>(__fadd_rn(a[e], d[e]));
      store16(xr + c, a);
    }
#pragma unroll
    for (int e = 0; e < N; ++e) ss = __fadd_rn(ss, __fmul_rn(a[e], a[e]));
  }
  ss = block_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / (float)D), eps));
  // the thread reads back the elements it wrote above
  for (int c = threadIdx.x * N; c < D; c += step) {
    float a[N], g[N];
    load16(xr + c, a);
    load16(w + c, g);
#pragma unroll
    for (int e = 0; e < N; ++e)
      a[e] = __fmul_rn(__fmul_rn(a[e], r), __fadd_rn(1.f, g[e]));
    store16(hr + c, a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rope_kv_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_pos,
                     const float* __restrict__ freqs, T* __restrict__ k_pages,
                     T* __restrict__ v_pages,
                     const long long* __restrict__ w_page,
                     const long long* __restrict__ w_off,
                     T* __restrict__ q_out, int Hq, int Hkv, int hd,
                     int psz) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float table[];            // cos [hd/2], then sin [hd/2]
  const int b = blockIdx.x;
  const int half = hd >> 1;
  const float pos = (float)q_pos[b];
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float s, c;
    sincosf(__fmul_rn(pos, freqs[i]), &s, &c);
    table[i] = c;
    table[half + i] = s;
  }
  __syncthreads();
  // the row's slot in the arena: (page, head, offset) -> element
  const size_t slot = (size_t)w_page[b] * Hkv * psz + (size_t)w_off[b];
  const int per_half = half / N, per_head = hd / N;
  const int n_rot = (Hq + Hkv) * per_half;
  const int n_all = n_rot + Hkv * per_head;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    if (i < n_rot) {
      const int head = i / per_half, c = (i % per_half) * N;
      const T* src;
      T* dst;
      if (head < Hq) {
        src = q + ((size_t)b * Hq + head) * hd;
        dst = q_out + ((size_t)b * Hq + head) * hd;
      } else {
        const int kh = head - Hq;
        src = k + ((size_t)b * Hkv + kh) * hd;
        dst = k_pages + (slot + (size_t)kh * psz) * hd;
      }
      float x1[N], x2[N], o1[N], o2[N];
      load16(src + c, x1);
      load16(src + half + c, x2);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float co = table[c + e], si = table[half + c + e];
        o1[e] = __fsub_rn(__fmul_rn(x1[e], co), __fmul_rn(x2[e], si));
        o2[e] = __fadd_rn(__fmul_rn(x2[e], co), __fmul_rn(x1[e], si));
      }
      store16(dst + c, o1);
      store16(dst + half + c, o2);
    } else {
      const int j = i - n_rot, kh = j / per_head, c = (j % per_head) * N;
      *reinterpret_cast<uint4*>(v_pages + (slot + (size_t)kh * psz) * hd + c) =
          *reinterpret_cast<const uint4*>(v + ((size_t)b * Hkv + kh) * hd + c);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
silu_mul_kernel(const T* __restrict__ g, const T* __restrict__ u,
                T* __restrict__ out, long long n_vec) {
  constexpr int N = Vec<T>::N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    float a[N], b[N];
    load16(g + i * N, a);
    load16(u + i * N, b);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float s = rnd<T>(__fdiv_rn(a[e], __fadd_rn(1.f, expf(-a[e]))));
      a[e] = __fmul_rn(s, b[e]);
    }
    store16(out + i * N, a);
  }
}

// threads for `items` work items: whole warps, at most kMaxThreads
int threads_for(long long items) {
  long long t = (items + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t));
}

bool aligned(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
int launch_norm(void* x, const void* delta, const void* w, void* h, int rows,
                int D, float eps, cudaStream_t s) {
  add_rms_norm_kernel<T><<<rows, threads_for(D / Vec<T>::N), 0, s>>>(
      static_cast<T*>(x), static_cast<const T*>(delta),
      static_cast<const T*>(w), static_cast<T*>(h), D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rope(const void* q, const void* k, const void* v,
                const void* q_pos, const void* freqs, void* k_pages,
                void* v_pages, const void* w_page, const void* w_off,
                void* q_out, int B, int Hq, int Hkv, int hd, int psz,
                cudaStream_t s) {
  const long long items = (long long)(Hq + Hkv) * (hd / 2 / Vec<T>::N) +
                          (long long)Hkv * (hd / Vec<T>::N);
  rope_kv_write_kernel<T><<<B, threads_for(items), hd * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const float*>(freqs), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), static_cast<const long long*>(w_page),
      static_cast<const long long*>(w_off), static_cast<T*>(q_out), Hq, Hkv,
      hd, psz);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_silu(const void* g, const void* u, void* out, long long n,
                cudaStream_t s) {
  const long long n_vec = n / Vec<T>::N;
  long long blocks = (n_vec + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  silu_mul_kernel<T><<<(int)blocks, 256, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(u),
      static_cast<T*>(out), n_vec);
  return (int)cudaGetLastError();
}

int elems16(int dtype) { return dtype == 0 ? 4 : 8; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor but the int ones and
// freqs. All tensors contiguous and 16-byte aligned. Each returns a
// cudaError_t (0 = launched).

// x, h [rows, D]; delta [rows, D] or null; w [D]. D % (16 / element size)
// == 0. x is updated in place.
int add_rms_norm(void* x, const void* delta, const void* w, void* h,
                 int rows, int D, float eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || (dtype != 0 && dtype != 1) ||
      D % elems16(dtype) != 0 || !aligned(x) || !aligned(w) || !aligned(h) ||
      (delta != nullptr && !aligned(delta)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_norm<float>(x, delta, w, h, rows, D, eps, s)
                    : launch_norm<bf16>(x, delta, w, h, rows, D, eps, s);
}

// q, q_out [B,Hq,hd]; k, v [B,Hkv,hd]; q_pos [B] int32; freqs [hd/2] fp32;
// k_pages, v_pages [P,Hkv,psz,hd] (one layer's); w_page, w_off [B] int64,
// each row's page (< P) and offset (< psz). hd % (2 * 16 / element size)
// == 0, hd <= 1024.
int rope_kv_write(const void* q, const void* k, const void* v,
                  const void* q_pos, const void* freqs, void* k_pages,
                  void* v_pages, const void* w_page, const void* w_off,
                  void* q_out, int B, int Hq, int Hkv, int hd, int psz,
                  int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || hd <= 0 || hd > 1024 || psz <= 0 ||
      (dtype != 0 && dtype != 1) || hd % (2 * elems16(dtype)) != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(k_pages) ||
      !aligned(v_pages) || !aligned(q_out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_rope<float>(q, k, v, q_pos, freqs, k_pages, v_pages,
                                  w_page, w_off, q_out, B, Hq, Hkv, hd, psz, s)
             : launch_rope<bf16>(q, k, v, q_pos, freqs, k_pages, v_pages,
                                 w_page, w_off, q_out, B, Hq, Hkv, hd, psz, s);
}

// g, u, out: n elements each, n % (16 / element size) == 0.
int silu_mul(const void* g, const void* u, void* out, long long n, int dtype,
             void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1) || n % elems16(dtype) != 0 ||
      !aligned(g) || !aligned(u) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_silu<float>(g, u, out, n, s)
                    : launch_silu<bf16>(g, u, out, n, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
