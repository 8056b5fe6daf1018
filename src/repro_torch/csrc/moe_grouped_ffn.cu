// Grouped-expert gated FFN over a dispatched buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_dispatch.py ::
// moe_grouped_ffn_kernel (pallas_call at moe_dispatch.py:37). Same
// function, per group g with expert e = g mod E:
//   out[g] = (silu(buf[g] Wg[e]) * (buf[g] Wu[e])) Wd[e]
// buf [G,C,D], wg/wu [E,D,F], wd [E,F,D] (fp32 or bf16, one type) ->
// out [G,C,D] in buf's type; products summed in fp32 and the hidden
// activation kept in fp32 between the two products, as the TPU kernel
// keeps it (moe_dispatch.py:17-28). Zero rows give zero rows. G = E for
// one dispatch group (decode); G = B*E takes the per-example buffers of a
// batch of prompts in one launch.
//
// What bounds it on the card: at granite-moe widths (E 40, D 1536, F 512)
// and C = 64 rows a group, device-memory bytes: every expert's three
// matrices (189 MB in bf16) are read for 2*3*C flops per weight, below
// the H100's ~295 flops/byte balance point.
//
// Design. Two kernels on the stream, one launch of this function: (1) a
// tiled product of 64 rows by 64 hidden columns per block for the gate
// and the up matrices together, epilogue silu(g)*u written to an fp32
// scratch [G,C,F]; (2) the down product, 64 rows by 64 output columns
// per block, over that scratch. 256 threads a block, each a 4x4 register
// tile per output (interleaved so shared-memory reads broadcast or run
// consecutively); 32-deep slices of the inputs staged in shared memory in
// fp32. Plain CUDA cores, no tensor cores, no skip of empty groups yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;             // rows (capacity slots) per block
constexpr int kTN = 64;             // output columns per block
constexpr int kTK = 32;             // depth of a staged slice
constexpr int kThreads = 256;       // 16 x 16, 4x4 outputs each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// Stage rows [r0, r0+kTM) x depth [k0, k0+kTK) of a row-major [rows, K]
// matrix into a[kTM][kTK+1], zeros outside.
template <typename S>
__device__ __forceinline__ void stage_a(float* a, const S* src, int rows,
                                        int K, int r0, int k0) {
  for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
    const int r = i / kTK, k = i % kTK;
    const int gr = r0 + r, gk = k0 + k;
    a[r * (kTK + 1) + k] =
        (gr < rows && gk < K) ? to_f(src[(size_t)gr * K + gk]) : 0.f;
  }
}

// Stage depth [k0, k0+kTK) x columns [n0, n0+kTN) of a row-major [K, Ncols]
// matrix into w[kTK][kTN], zeros outside.
template <typename T>
__device__ __forceinline__ void stage_w(float* w, const T* src, int K,
                                        int Ncols, int k0, int n0) {
  for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
    const int k = i / kTN, n = i % kTN;
    const int gk = k0 + k, gn = n0 + n;
    w[i] = (gk < K && gn < Ncols) ? to_f(src[(size_t)gk * Ncols + gn]) : 0.f;
  }
}

// (1) hid[g] = silu(buf[g] Wg[e]) * (buf[g] Wu[e]), fp32 [G,C,F]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_up_kernel(const T* __restrict__ buf, const T* __restrict__ wg,
               const T* __restrict__ wu, float* __restrict__ hid, int E,
               int C, int D, int F) {
  __shared__ float a_s[kTM * (kTK + 1)];
  __shared__ float g_s[kTK * kTN];
  __shared__ float u_s[kTK * kTN];
  const int n0 = blockIdx.x * kTN;
  const int r0 = blockIdx.y * kTM;
  const int g = blockIdx.z;
  const int e = g % E;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* x = buf + (size_t)g * C * D;
  const T* Wg = wg + (size_t)e * D * F;
  const T* Wu = wu + (size_t)e * D * F;
  float ga[4][4], ua[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ga[i][j] = ua[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kTK) {
    stage_a(a_s, x, C, D, r0, k0);
    stage_w(g_s, Wg, D, F, k0, n0);
    stage_w(u_s, Wu, D, F, k0, n0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTK; ++k) {
      float av[4], gv[4], uv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[(ty + 16 * i) * (kTK + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = g_s[k * kTN + tx + 16 * j];
        uv[j] = u_s[k * kTN + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ga[i][j] += av[i] * gv[j];
          ua[i][j] += av[i] * uv[j];
        }
    }
    __syncthreads();
  }
  float* out = hid + (size_t)g * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= F) continue;
      const float gv = ga[i][j];
      out[(size_t)r * F + n] = gv / (1.f + expf(-gv)) * ua[i][j];
    }
  }
}

// (2) out[g] = hid[g] Wd[e], in T [G,C,D]
template <typename T>
__global__ void __launch_bounds__(kThreads)
down_kernel(const float* __restrict__ hid, const T* __restrict__ wd,
            T* __restrict__ out, int E, int C, int D, int F) {
  __shared__ float a_s[kTM * (kTK + 1)];
  __shared__ float w_s[kTK * kTN];
  const int n0 = blockIdx.x * kTN;
  const int r0 = blockIdx.y * kTM;
  const int g = blockIdx.z;
  const int e = g % E;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* h = hid + (size_t)g * C * F;
  const T* Wd = wd + (size_t)e * F * D;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < F; k0 += kTK) {
    stage_a(a_s, h, C, F, r0, k0);
    stage_w(w_s, Wd, F, D, k0, n0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTK; ++k) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[(ty + 16 * i) * (kTK + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[k * kTN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }
  T* o = out + (size_t)g * C * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < D) store_f(acc[i][j], o + (size_t)r * D + n);
    }
  }
}

template <typename T>
int launch(const void* buf, const void* wg, const void* wu, const void* wd,
           float* hid, void* out, int G, int E, int C, int D, int F,
           cudaStream_t stream) {
  const int row_tiles = (C + kTM - 1) / kTM;
  dim3 g1((F + kTN - 1) / kTN, row_tiles, G);
  gate_up_kernel<T><<<g1, kThreads, 0, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(wg),
      static_cast<const T*>(wu), hid, E, C, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((D + kTN - 1) / kTN, row_tiles, G);
  down_kernel<T><<<g2, kThreads, 0, stream>>>(
      hid, static_cast<const T*>(wd), static_cast<T*>(out), E, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. buf [G,C,D], wg/wu [E,D,F], wd [E,F,D],
// out [G,C,D] contiguous in that type; hid a contiguous fp32 scratch
// [G,C,F]; G a multiple of E. Returns a cudaError_t (0 = launched).
int moe_grouped_ffn(const void* buf, const void* wg, const void* wu,
                    const void* wd, void* hid, void* out, int G, int E,
                    int C, int D, int F, int dtype, void* stream) {
  if (G <= 0 || G > 65535 || E <= 0 || G % E != 0 || C <= 0 || D <= 0 ||
      F <= 0 || (C + kTM - 1) / kTM > 65535)
    return (int)cudaErrorInvalidValue;
  float* h = static_cast<float*>(hid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(buf, wg, wu, wd, h, out, G, E, C, D, F, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(buf, wg, wu, wd, h, out, G, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
