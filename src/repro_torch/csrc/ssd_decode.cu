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
// and written once, 2*P*N*4 bytes per (row, head) (64 KB at Mamba2
// widths), for four flops per element (decay, rank-1 update, product with
// C, its sum): 0.5 flop a byte, far under the card's ~20 in fp32.
//
// Why the first design (one block of 128 threads per (head, row)) stayed
// under half of that bound: each warp stepped through its state rows one
// after another, one 16-byte load a lane and a shuffle reduction per row,
// so a block had at most four rows in flight (2 KB at N = 128) and the
// card ~0.8 MB at mamba2-780m's paged batch, where Little's law at
// 3.35 TB/s and ~0.6 us of DRAM latency asks for ~2 MB: 41% of the bound.
// At hymba-1.5b's N = 16 only 4 lanes of a warp loaded (256 B a block):
// 12%. It was bound by latency, not by bytes.
//
// Design. The work unit is a slab: rows [p0, p0 + Pt) of one (slot, head)
// state tile, Pt*N*4 contiguous bytes, 16-byte aligned since N % 4 == 0.
// kernels/ssd_decode.plan picks Pt (~8 KB slabs, a whole tile where it is
// smaller: hymba's 4 KB tiles are not cut) and the threads; one block per
// (slab, head, row). The block's first act is one bulk copy of its whole
// slab into shared memory (cp.async.bulk, completing on an mbarrier);
// while it flies the threads load B, C, the slab's x and dt and compute
// the decay. So every block has its whole slab in flight at once: ~12 MB
// across the card at mamba2's paged batch. Then the threads sweep the
// flattened slab, thread t taking float4s t, t+T, ... (every lane works
// whatever N is): update, store back to the arena from registers
// (coalesced 16-byte stores, already fire-and-forget, so a bulk store
// would only add a fence, a block barrier and a wait), and the dot with
// C. y[p] sums the N/4 consecutive float4s of row p: a butterfly of
// shuffles when N/4 is a power of two <= 32 (a row's float4s then lie in
// one aligned group of lanes), else each float4's partial goes to shared
// memory and one thread a row adds them in column order. Both orders are
// fixed: two calls give the same bits, and a captured step the eager
// one's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBarBytes = 16;     // the mbarrier, ahead of the slab

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// log(1 + e^v) as jax.nn.softplus computes it (logaddexp(v, 0))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// y's reduction over a row's Q = N/4 float4s: shuffles when Q is a power
// of two <= 32, else shared memory (kernels/ssd_decode.plan's `shuffle`)
__host__ __device__ __forceinline__ bool by_shuffle(int Q) {
  return Q <= 32 && (Q & (Q - 1)) == 0;
}

// Dynamic shared memory of a block: [barrier | slab rows*N | B N | C N |
// x rows | partials rows*N/4 (shared-memory reduction only)], in floats
// after the barrier (kernels/ssd_decode.plan's `smem`).
__host__ __device__ __forceinline__ size_t smem_bytes(int rows, int N) {
  const int Q = N / 4;
  return kBarBytes + 4 * ((size_t)rows * N + 2 * (size_t)N + rows +
                          (by_shuffle(Q) ? 0 : (size_t)rows * Q));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ssd_decode_kernel(const T* __restrict__ x, const T* __restrict__ dtr,
                  const T* __restrict__ a_log, const T* __restrict__ d_skip,
                  const T* __restrict__ dt_bias, const T* __restrict__ bm,
                  const T* __restrict__ cm, float* __restrict__ state,
                  const int* __restrict__ slots,
                  const unsigned char* __restrict__ active,
                  T* __restrict__ y, int H, int P, int N, int rows, int slabs,
                  long long xs_b, long long xs_h, long long ds_b,
                  long long bs_b, long long cs_b) {
  const int h = blockIdx.x / slabs;
  const int p0 = (blockIdx.x - h * slabs) * rows;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nr = min(rows, P - p0);          // rows of this slab
  const int slot = slots[b];
  T* yr = y + ((size_t)b * H + h) * P + p0;
  if (slot < 0) {
    for (int r = tid; r < nr; r += nt) store_f(0.f, yr + r);
    return;
  }
  const int Q = N / 4;
  const int nf4 = nr * Q;                    // float4s of the slab
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar = smem_addr(smem);
  float* slab = reinterpret_cast<float*>(smem + kBarBytes);
  float* bs = slab + (size_t)rows * N;
  float* cs = bs + N;
  float* xs = cs + N;
  float* red = xs + rows;
  float4* hs = reinterpret_cast<float4*>(
      state + (((size_t)slot * H + h) * P + p0) * N);
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    fence_proxy_async();
    mbar_arrive_expect_tx(bar, (uint32_t)nf4 * 16);
    bulk_load(smem_addr(slab), hs, (uint32_t)nf4 * 16, bar);
  }
  // while the slab flies
  for (int j = tid; j < N; j += nt) {
    bs[j] = to_f(bm[b * bs_b + j]);
    cs[j] = to_f(cm[b * cs_b + j]);
  }
  const T* xr = x + b * xs_b + h * xs_h + p0;
  for (int r = tid; r < nr; r += nt) xs[r] = to_f(xr[r]);
  const float A = -expf(to_f(a_log[h]));
  const float dt = softplus(to_f(dtr[b * ds_b + h]) + to_f(dt_bias[h]));
  const float g = expf(dt * A);
  const float Dk = to_f(d_skip[h]);
  const bool do_write = active[b] != 0;
  const bool shuffle = by_shuffle(Q);
  __syncthreads();               // B, C, x in place; the barrier initialised
  mbar_wait(bar, 0);

  const float4* s4 = reinterpret_cast<const float4*>(slab);
  const float4* b4 = reinterpret_cast<const float4*>(bs);
  const float4* c4 = reinterpret_cast<const float4*>(cs);
  const int steps = (nf4 + nt - 1) / nt;     // the same for every thread
  for (int k = 0; k < steps; ++k) {
    const int i = tid + k * nt;
    const bool live = i < nf4;               // uniform over a row's lanes
    const int r = i / Q;
    const int j4 = i - r * Q;
    float part = 0.f;
    if (live) {
      float4 v = s4[i];
      const float4 bb = b4[j4], cc = c4[j4];
      const float xd = xs[r] * dt;
      v.x = v.x * g + xd * bb.x;
      v.y = v.y * g + xd * bb.y;
      v.z = v.z * g + xd * bb.z;
      v.w = v.w * g + xd * bb.w;
      part = v.x * cc.x + v.y * cc.y + v.z * cc.z + v.w * cc.w;
      if (do_write) hs[i] = v;
    }
    if (shuffle) {
      // nt % 32 == 0 and Q | 32: lanes i .. i^(Q-1) hold one row
      for (int o = Q >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o);
      if (live && j4 == 0) store_f(part + Dk * xs[r], yr + r);
    } else if (live) {
      red[i] = part;
    }
  }
  if (!shuffle) {
    __syncthreads();
    for (int r = tid; r < nr; r += nt) {
      float acc = 0.f;
      for (int q = 0; q < Q; ++q) acc += red[r * Q + q];
      store_f(acc + Dk * xs[r], yr + r);
    }
  }
}

__global__ void empty_kernel() {}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log,
           const void* d_skip, const void* dt_bias, const void* bm,
           const void* cm, float* state, const int* slots,
           const unsigned char* active, void* y, int B, int H, int P, int N,
           int rows, int threads, const long long* s, cudaStream_t stream) {
  const int slabs = (P + rows - 1) / rows;
  const size_t smem = smem_bytes(rows, N);
  // raised once per instantiation and size, never on every launch (a
  // launch inside a graph capture asks again for the size it had)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  dim3 grid((unsigned)(H * slabs), B);
  ssd_decode_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(a_log), static_cast<const T*>(d_skip),
      static_cast<const T*>(dt_bias), static_cast<const T*>(bm),
      static_cast<const T*>(cm), state, slots, active, static_cast<T*>(y),
      H, P, N, rows, slabs, s[0], s[1], s[2], s[3], s[4]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and the [H] parameters in
// one type). state: the layer's [S,H,P,N] fp32 arena, 16-byte aligned,
// N % 4 == 0. slots [B] int32, active [B] bool (one byte). rows, threads:
// the slab plan (kernels/ssd_decode.plan): state rows a slab, threads a
// block (a multiple of 32, at most 128). strides: x (b, h), dt (b), b (b),
// c (b) in elements; the last dimension of each is contiguous. y
// contiguous [B,H,P]. Returns a cudaError_t (0 = launched).
int ssd_decode_step(const void* x, const void* dt, const void* a_log,
                    const void* d_skip, const void* dt_bias, const void* b,
                    const void* c, void* state, const void* slots,
                    const void* active, void* y, int B, int H, int P, int N,
                    int rows, int threads, const long long* strides,
                    int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || P <= 0 || N <= 0 || N % 4 != 0 ||
      rows <= 0 || rows > P || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 ||
      (long long)H * ((P + rows - 1) / rows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(state);
  const int* sl = static_cast<const int*>(slots);
  const unsigned char* av = static_cast<const unsigned char*>(active);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, d_skip, dt_bias, b, c, st, sl, av, y,
                         B, H, P, N, rows, threads, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_log, d_skip, dt_bias, b, c, st, sl,
                                 av, y, B, H, P, N, rows, threads, strides,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel on a grid of `blocks` blocks of `threads`: the launch
// floor that the step's time is read against.
int ssd_decode_empty(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
