// Mamba2 SSD single-token decode step over the state arena, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_decode.py ::
// ssd_decode_step_kernel (pallas_call at ssd_decode.py:41). Same step per
// (row b, head h):
//   h' = exp(dt A) h + dt x B^T,   y = h' C + D x
// with dt = softplus(dt_raw + dt_bias[h]) and A = -exp(a_log[h]); x [B,H,P]
// (read through its strides), dt [B,H], b, c [B,N] (fp32 or bf16), the
// [H] parameters in the same type -> y [B,H,P] contiguous in x's type;
// state fp32. Unlike the TPU kernel, which takes h [B,H,P,N] and returns
// h', this kernel reads and writes the layer's state arena [S,H,P,N] in
// place through the row's slot: it folds in the gather and the dropped
// scatter that the JAX model wraps around its step (model.py:697-707).
// Rows that are inactive, or whose slot is -1, write nothing; a slot -1
// row reads nothing and gives y = 0. Live rows' slots must be distinct.
//
// What bounds it on the card: device-memory bytes. The fp32 state is read
// and written once (2*P*N*4 bytes per (row, head), 64 KB at Mamba2
// widths) for 4 flops per element.
//
// Design. One block of 128 threads per (head, row). Each warp takes state
// rows p in turn; its lanes sweep the N columns in float4 loads and
// stores (N % 4 == 0), update the row in registers, and reduce h'.C over
// the warp with shuffles. B and C of the row sit in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// log(1 + e^v) as jax.nn.softplus computes it (logaddexp(v, 0))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_decode_kernel(const T* __restrict__ x, const T* __restrict__ dtr,
                  const T* __restrict__ a_log, const T* __restrict__ d_skip,
                  const T* __restrict__ dt_bias, const T* __restrict__ bm,
                  const T* __restrict__ cm, float* __restrict__ state,
                  const int* __restrict__ slots,
                  const unsigned char* __restrict__ active,
                  T* __restrict__ y, int H, int P, int N, long long xs_b,
                  long long xs_h, long long ds_b, long long bs_b,
                  long long cs_b) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int slot = slots[b];
  T* yr = y + ((size_t)b * H + h) * P;
  if (slot < 0) {
    for (int p = tid; p < P; p += kThreads) store_f(0.f, yr + p);
    return;
  }
  const bool do_write = active[b] != 0;

  extern __shared__ float smem[];
  float* bs = smem;                 // [N]
  float* cs = smem + N;             // [N]
  for (int j = tid; j < N; j += kThreads) {
    bs[j] = to_f(bm[b * bs_b + j]);
    cs[j] = to_f(cm[b * cs_b + j]);
  }
  __syncthreads();

  const float A = -expf(to_f(a_log[h]));
  const float dt = softplus(to_f(dtr[b * ds_b + h]) + to_f(dt_bias[h]));
  const float g = expf(dt * A);
  const float Dk = to_f(d_skip[h]);
  float* hs = state + ((size_t)slot * H + h) * P * N;
  const int warp = tid / 32, lane = tid % 32;
  const T* xr = x + b * xs_b + h * xs_h;
  for (int p = warp; p < P; p += kThreads / 32) {
    const float xv = to_f(xr[p]);
    const float xd = xv * dt;
    float4* row = reinterpret_cast<float4*>(hs + (size_t)p * N);
    float acc = 0.f;
    for (int j4 = lane; j4 < N / 4; j4 += 32) {
      const int j = 4 * j4;
      float4 v = row[j4];
      v.x = v.x * g + xd * bs[j];
      v.y = v.y * g + xd * bs[j + 1];
      v.z = v.z * g + xd * bs[j + 2];
      v.w = v.w * g + xd * bs[j + 3];
      acc += v.x * cs[j] + v.y * cs[j + 1] + v.z * cs[j + 2] + v.w * cs[j + 3];
      if (do_write) row[j4] = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) store_f(acc + Dk * xv, yr + p);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log,
           const void* d_skip, const void* dt_bias, const void* bm,
           const void* cm, float* state, const int* slots,
           const unsigned char* active, void* y, int B, int H, int P, int N,
           const long long* s, cudaStream_t stream) {
  dim3 grid(H, B);
  const size_t smem = 2 * (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(a_log), static_cast<const T*>(d_skip),
      static_cast<const T*>(dt_bias), static_cast<const T*>(bm),
      static_cast<const T*>(cm), state, slots, active, static_cast<T*>(y),
      H, P, N, s[0], s[1], s[2], s[3], s[4]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and the [H] parameters in
// one type). state: the layer's [S,H,P,N] fp32 arena, 16-byte aligned,
// N % 4 == 0. slots [B] int32, active [B] bool (one byte). strides: x
// (b, h), dt (b), b (b), c (b) in elements; the last dimension of each is
// contiguous. y contiguous [B,H,P]. Returns a cudaError_t (0 = launched).
int ssd_decode_step(const void* x, const void* dt, const void* a_log,
                    const void* d_skip, const void* dt_bias, const void* b,
                    const void* c, void* state, const void* slots,
                    const void* active, void* y, int B, int H, int P, int N,
                    const long long* strides, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || P <= 0 || N <= 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(state);
  const int* sl = static_cast<const int*>(slots);
  const unsigned char* av = static_cast<const unsigned char*>(active);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, d_skip, dt_bias, b, c, st, sl, av, y,
                         B, H, P, N, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_log, d_skip, dt_bias, b, c, st, sl,
                                 av, y, B, H, P, N, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
