// Grouped-expert gated FFN over a dispatched buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_dispatch.py ::
// moe_grouped_ffn_kernel (pallas_call at moe_dispatch.py:37). Same
// function, per group g with expert e = g mod E:
//   out[g] = (silu(buf[g] Wg[e]) * (buf[g] Wu[e])) Wd[e]
// buf [G,C,D], wg/wu [E,D,F], wd [E,F,D] (fp32 or bf16, one type) ->
// out [G,C,D] in buf's type; products summed in fp32 and the hidden
// activation kept in fp32 between the two products, as the TPU kernel
// keeps it (moe_dispatch.py:17-28). G = E for one dispatch group (decode);
// G = B*E takes the per-example buffers of a batch of prompts in one
// launch. counts [G] int32 (or null: every row live) holds the live rows
// of each group, rows 0..counts[g]-1; rows at or past it are written as
// exact zeros and never read, and a group with no row reads no weight.
//
// What bounds it on the card: device-memory bytes. Each weight is read
// once for at most B live rows at decode (granite-moe b=8: ~1.6 rows an
// expert) and at most C = 64 at prefill, 2 flops per row per weight, far
// under the H100's ~295 flops/byte balance point. So the kernel has to
// read the weights of experts with rows at full bandwidth, and nothing
// else: at granite-moe widths (E 40, D 1536, F 512) that is 4.7 MB an
// expert with rows, 189 MB if all 40 have one.
//
// Design (bf16, the serving type). Two kernels on the stream, one launch
// of this function. Both compute the transposed product, so the weights
// are the wide operand: the 16-row M side of mma.sync m16n8k16 takes
// weight columns, and the group's live rows, padded to 8, are N; rows are
// taken 64 at a time, so the weights stream once per 64 live rows.
// (1) gate/up: h^T[F,n] = Wg^T[F,D] x^T[D,n] and the same for Wu, a block
// per (64 hidden columns, group), 4 warps of 16 columns each; epilogue
// silu(g)*u into an fp32 scratch [G,C,F] (live rows only).
// (2) down: out^T[D,n] = Wd^T[D,F] h^T[F,n], a block per (64 output
// columns, group). The fp32 hidden is split into two bf16 parts (hi +
// lo, the product taken twice), so it keeps ~16 bits through the tensor
// cores. The weights are stored with the M side contiguous (Wg [D,F], Wd
// [F,D]), so the A fragments come transposed out of shared memory by
// ldmatrix.trans; the rows' B fragments are read as they lie. A 4-stage
// ring of 32-deep tiles is fed by 16-byte cp.async (zero fill past the
// edges and the count), so three tiles' copies are in flight during each
// tile's products. The grid spreads over weight tiles: 8 x 40 blocks for
// gate/up and 24 x 40 for down at granite-moe's decode shape, and the
// blocks of an empty group exit at once (down first writes its zeros).
// fp32 (the checks' type; no tensor-core path keeps 1e-4) runs a
// CUDA-core body: 64x64 tiles in shared memory, 4x4 outputs a thread,
// with the same counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// live rows of group g: counts[g] clamped to [0, C], or C without counts
__device__ __forceinline__ int live_rows(const int* counts, int g, int C) {
  return counts ? min(max(counts[g], 0), C) : C;
}

// ------------------------------------------------ tensor-core body (bf16)
namespace tc {

using bf16 = __nv_bfloat16;
using hopper::cp_async16;
using hopper::smem_addr;

constexpr int kMT = 64;             // weight columns per block (4 warps x 16)
constexpr int kKT = 32;             // depth of a ring stage
constexpr int kNT = 64;             // live rows a pass holds (8 tiles of 8)
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kWS = kMT + 8;        // weight tile row stride (elements):
                                    // 144 B, ldmatrix rows conflict-free
constexpr int kXS = kKT + 8;        // bf16 row tile stride: 80 B
constexpr int kHS = kKT + 8;        // fp32 hidden tile stride: 160 B
constexpr int kWTile = kKT * kWS;   // elements of one weight tile
constexpr int kUpStage = 2 * kWTile * 2 + kNT * kXS * 2;      // bytes
constexpr int kDownStage = kWTile * 2 + kNT * kHS * 4;        // bytes
constexpr int kUpSmem = kStages * kUpStage;
constexpr int kDownSmem = kStages * kDownStage;

// A fragments of W^T for this warp's 16 columns and depth kk..kk+15 from
// a [kKT][kWS] tile of W (depth rows, columns contiguous): matrix i of
// the x4 load is depth rows kk + 8(i/2), columns 16 warp + 8(i%2).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int kk, int warp, int lane) {
  const int i = lane / 8;
  hopper::ldmatrix_x4_trans(
      a, smem_addr(tile + (kk + 8 * (i / 2) + lane % 8) * kWS + warp * 16 +
                   8 * (i % 2)));
}

// (1) hid[g][r] = silu(buf[g][r] Wg[e]) * (buf[g][r] Wu[e]), fp32, for the
// live rows r < count of group g, hidden columns f0..f0+63
__global__ void __launch_bounds__(kThreads)
gate_up(const bf16* __restrict__ buf, const bf16* __restrict__ wg,
        const bf16* __restrict__ wu, const int* __restrict__ counts,
        float* __restrict__ hid, int E, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.y;
  const int n = live_rows(counts, grp, C);
  if (n == 0) return;                               // reads no weight
  const int f0 = blockIdx.x * kMT;
  const int e = grp % E;
  const bf16* x = buf + (size_t)grp * C * D;
  const bf16* Wg = wg + (size_t)e * D * F;
  const bf16* Wu = wu + (size_t)e * D * F;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (D + kKT - 1) / kKT;

  for (int r0 = 0; r0 < n; r0 += kNT) {
    const int rows = min(kNT, n - r0);
    const int ntile = (rows + 7) / 8;
    // stage: Wg tile, Wu tile, rows [ntile*8][kXS]
    auto load = [&](int slot, int kt) {
      bf16* s = reinterpret_cast<bf16*>(smem + slot * kUpStage);
      const int k0 = kt * kKT;
      for (int i = tid; i < 2 * kKT * (kMT / 8); i += kThreads) {
        const int mat = i / (kKT * kMT / 8), j = i % (kKT * kMT / 8);
        const int kr = j / (kMT / 8), ch = j % (kMT / 8);
        const int gk = k0 + kr, gf = f0 + ch * 8;
        const bool ok = gk < D && gf < F;
        cp_async16(smem_addr(s + mat * kWTile + kr * kWS + ch * 8),
                   (mat ? Wu : Wg) + (ok ? (size_t)gk * F + gf : 0),
                   ok ? 16 : 0);
      }
      for (int i = tid; i < ntile * 8 * (kKT / 8); i += kThreads) {
        const int r = i / (kKT / 8), ch = i % (kKT / 8);
        const int gk = k0 + ch * 8;
        const bool ok = r < rows && gk < D;
        cp_async16(smem_addr(s + 2 * kWTile + r * kXS + ch * 8),
                   x + (ok ? (size_t)(r0 + r) * D + gk : 0), ok ? 16 : 0);
      }
    };
    float ga[kNT / 8][4], ua[kNT / 8][4];
#pragma unroll
    for (int j = 0; j < kNT / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) ga[j][q] = ua[j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      hopper::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      hopper::cp_async_wait<kStages - 2>();
      __syncthreads();              // tile kt landed; tile kt-1 consumed
      if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages,
                                      kt + kStages - 1);
      hopper::cp_async_commit();
      const bf16* s =
          reinterpret_cast<const bf16*>(smem + (kt % kStages) * kUpStage);
      const bf16* xs = s + 2 * kWTile;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        uint32_t ag[4], au[4];
        load_a(ag, s, kk, warp, lane);
        load_a(au, s + kWTile, kk, warp, lane);
#pragma unroll
        for (int j = 0; j < kNT / 8; ++j) {
          if (j < ntile) {
            // B(k, r) = x[r][k]: two depth-adjacent values of row j*8+g
            const bf16* xr = xs + (j * 8 + lane / 4) * kXS + kk +
                             2 * (lane % 4);
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
            hopper::mma_16816(ga[j], ag, b0, b1);
            hopper::mma_16816(ua[j], au, b0, b1);
          }
        }
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();                // the ring is free for the next pass

    float* hg = hid + ((size_t)grp * C + r0) * F;
#pragma unroll
    for (int j = 0; j < kNT / 8; ++j) {
      if (j >= ntile) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = f0 + warp * 16 + lane / 4 + (q >= 2 ? 8 : 0);
        const int r = j * 8 + 2 * (lane % 4) + (q & 1);
        if (r < rows && f < F) {
          const float gv = ga[j][q];
          hg[(size_t)r * F + f] = gv / (1.f + expf(-gv)) * ua[j][q];
        }
      }
    }
  }
}

// fp32 pair -> two bf16 pairs whose sum is the pair to ~16 bits
__device__ __forceinline__ void split_bf16(float2 v, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (2) out[g][r] = hid[g][r] Wd[e] for r < count, exact zeros after;
// output columns d0..d0+63
__global__ void __launch_bounds__(kThreads)
down(const float* __restrict__ hid, const bf16* __restrict__ wd,
     const int* __restrict__ counts, bf16* __restrict__ out, int E, int C,
     int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.y;
  const int n = live_rows(counts, grp, C);
  const int d0 = blockIdx.x * kMT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* og = out + (size_t)grp * C * D;
  for (int i = tid; i < (C - n) * (kMT / 8); i += kThreads) {
    const int r = n + i / (kMT / 8), d = d0 + (i % (kMT / 8)) * 8;
    if (d < D)
      *reinterpret_cast<uint4*>(og + (size_t)r * D + d) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (n == 0) return;                               // reads no weight
  const bf16* Wd = wd + (size_t)(grp % E) * F * D;
  const float* hg = hid + (size_t)grp * C * F;
  const int nk = (F + kKT - 1) / kKT;

  for (int r0 = 0; r0 < n; r0 += kNT) {
    const int rows = min(kNT, n - r0);
    const int ntile = (rows + 7) / 8;
    // stage: Wd tile [kKT][kWS] bf16, hidden rows [ntile*8][kHS] fp32
    auto load = [&](int slot, int kt) {
      unsigned char* s = smem + slot * kDownStage;
      const bf16* ws = reinterpret_cast<const bf16*>(s);
      const float* hs = reinterpret_cast<const float*>(s + kWTile * 2);
      const int k0 = kt * kKT;
      for (int i = tid; i < kKT * (kMT / 8); i += kThreads) {
        const int kr = i / (kMT / 8), ch = i % (kMT / 8);
        const int gk = k0 + kr, gd = d0 + ch * 8;
        const bool ok = gk < F && gd < D;
        cp_async16(smem_addr(ws + kr * kWS + ch * 8),
                   Wd + (ok ? (size_t)gk * D + gd : 0), ok ? 16 : 0);
      }
      for (int i = tid; i < ntile * 8 * (kKT / 4); i += kThreads) {
        const int r = i / (kKT / 4), ch = i % (kKT / 4);
        const int gk = k0 + ch * 4;
        const bool ok = r < rows && gk < F;
        cp_async16(smem_addr(hs + r * kHS + ch * 4),
                   hg + (ok ? (size_t)(r0 + r) * F + gk : 0), ok ? 16 : 0);
      }
    };
    float acc[kNT / 8][4];
#pragma unroll
    for (int j = 0; j < kNT / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      hopper::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      hopper::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages,
                                      kt + kStages - 1);
      hopper::cp_async_commit();
      const unsigned char* s = smem + (kt % kStages) * kDownStage;
      const bf16* ws = reinterpret_cast<const bf16*>(s);
      const float* hs = reinterpret_cast<const float*>(s + kWTile * 2);
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        uint32_t a[4];
        load_a(a, ws, kk, warp, lane);
#pragma unroll
        for (int j = 0; j < kNT / 8; ++j) {
          if (j < ntile) {
            const float* hr = hs + (j * 8 + lane / 4) * kHS + kk +
                              2 * (lane % 4);
            uint32_t h0, l0, h1, l1;
            split_bf16(*reinterpret_cast<const float2*>(hr), h0, l0);
            split_bf16(*reinterpret_cast<const float2*>(hr + 8), h1, l1);
            hopper::mma_16816(acc[j], a, h0, h1);
            hopper::mma_16816(acc[j], a, l0, l1);
          }
        }
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kNT / 8; ++j) {
      if (j >= ntile) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + warp * 16 + lane / 4 + (q >= 2 ? 8 : 0);
        const int r = j * 8 + 2 * (lane % 4) + (q & 1);
        if (r < rows && d < D)
          og[(size_t)(r0 + r) * D + d] = __float2bfloat16(acc[j][q]);
      }
    }
  }
}

int launch(const void* buf, const void* wg, const void* wu, const void* wd,
           const int* counts, float* hid, void* out, int G, int E, int C,
           int D, int F, cudaStream_t stream) {
  static const cudaError_t up_attr = cudaFuncSetAttribute(
      gate_up, cudaFuncAttributeMaxDynamicSharedMemorySize, kUpSmem);
  static const cudaError_t down_attr = cudaFuncSetAttribute(
      down, cudaFuncAttributeMaxDynamicSharedMemorySize, kDownSmem);
  if (up_attr != cudaSuccess) return (int)up_attr;
  if (down_attr != cudaSuccess) return (int)down_attr;
  gate_up<<<dim3((F + kMT - 1) / kMT, G), kThreads, kUpSmem, stream>>>(
      static_cast<const bf16*>(buf), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), counts, hid, E, C, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down<<<dim3((D + kMT - 1) / kMT, G), kThreads, kDownSmem, stream>>>(
      hid, static_cast<const bf16*>(wd), counts, static_cast<bf16*>(out), E,
      C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------- CUDA-core body (fp32)
namespace cc {

constexpr int kTM = 64;             // rows (capacity slots) per block
constexpr int kTN = 64;             // output columns per block
constexpr int kTK = 32;             // depth of a staged slice
constexpr int kThreads = 256;       // 16 x 16, 4x4 outputs each

// Stage rows [r0, r0+kTM) x depth [k0, k0+kTK) of a row-major [*, K]
// matrix into a[kTM][kTK+1], zeros at or past row `rows` and depth K.
__device__ __forceinline__ void stage_a(float* a, const float* src, int rows,
                                        int K, int r0, int k0) {
  for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
    const int r = i / kTK, k = i % kTK;
    const int gr = r0 + r, gk = k0 + k;
    a[r * (kTK + 1) + k] =
        (gr < rows && gk < K) ? src[(size_t)gr * K + gk] : 0.f;
  }
}

// Stage depth [k0, k0+kTK) x columns [n0, n0+kTN) of a row-major [K, Ncols]
// matrix into w[kTK][kTN], zeros outside.
__device__ __forceinline__ void stage_w(float* w, const float* src, int K,
                                        int Ncols, int k0, int n0) {
  for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
    const int k = i / kTN, n = i % kTN;
    const int gk = k0 + k, gn = n0 + n;
    w[i] = (gk < K && gn < Ncols) ? src[(size_t)gk * Ncols + gn] : 0.f;
  }
}

// (1) hid[g] = silu(buf[g] Wg[e]) * (buf[g] Wu[e]) for the live rows
__global__ void __launch_bounds__(kThreads)
gate_up(const float* __restrict__ buf, const float* __restrict__ wg,
        const float* __restrict__ wu, const int* __restrict__ counts,
        float* __restrict__ hid, int E, int C, int D, int F) {
  __shared__ float a_s[kTM * (kTK + 1)];
  __shared__ float g_s[kTK * kTN];
  __shared__ float u_s[kTK * kTN];
  const int n0 = blockIdx.x * kTN;
  const int r0 = blockIdx.y * kTM;
  const int g = blockIdx.z;
  const int live = live_rows(counts, g, C);
  if (r0 >= live) return;
  const int e = g % E;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* x = buf + (size_t)g * C * D;
  const float* Wg = wg + (size_t)e * D * F;
  const float* Wu = wu + (size_t)e * D * F;
  float ga[4][4], ua[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ga[i][j] = ua[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kTK) {
    stage_a(a_s, x, live, D, r0, k0);
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
    if (r >= live) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= F) continue;
      const float gv = ga[i][j];
      out[(size_t)r * F + n] = gv / (1.f + expf(-gv)) * ua[i][j];
    }
  }
}

// (2) out[g] = hid[g] Wd[e] for the live rows, exact zeros after
__global__ void __launch_bounds__(kThreads)
down(const float* __restrict__ hid, const float* __restrict__ wd,
     const int* __restrict__ counts, float* __restrict__ out, int E, int C,
     int D, int F) {
  __shared__ float a_s[kTM * (kTK + 1)];
  __shared__ float w_s[kTK * kTN];
  const int n0 = blockIdx.x * kTN;
  const int r0 = blockIdx.y * kTM;
  const int g = blockIdx.z;
  const int live = live_rows(counts, g, C);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* o = out + (size_t)g * C * D;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (r0 < live) {                  // block-uniform
    const float* h = hid + (size_t)g * C * F;
    const float* Wd = wd + (size_t)(g % E) * F * D;
    for (int k0 = 0; k0 < F; k0 += kTK) {
      stage_a(a_s, h, live, F, r0, k0);
      stage_w(w_s, Wd, F, D, k0, n0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTK; ++k) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = a_s[(ty + 16 * i) * (kTK + 1) + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = w_s[k * kTN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
      }
      __syncthreads();
    }
  }
  // rows past the count were staged as zeros: they store exact zeros
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < D) o[(size_t)r * D + n] = acc[i][j];
    }
  }
}

int launch(const void* buf, const void* wg, const void* wu, const void* wd,
           const int* counts, float* hid, void* out, int G, int E, int C,
           int D, int F, cudaStream_t stream) {
  const int row_tiles = (C + kTM - 1) / kTM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  gate_up<<<dim3((F + kTN - 1) / kTN, row_tiles, G), kThreads, 0, stream>>>(
      static_cast<const float*>(buf), static_cast<const float*>(wg),
      static_cast<const float*>(wu), counts, hid, E, C, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down<<<dim3((D + kTN - 1) / kTN, row_tiles, G), kThreads, 0, stream>>>(
      hid, static_cast<const float*>(wd), counts, static_cast<float*>(out), E,
      C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace cc

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body).
// buf [G,C,D], wg/wu [E,D,F], wd [E,F,D], out [G,C,D] contiguous in that
// type; counts [G] int32 or null; hid a contiguous fp32 scratch [G,C,F];
// G a multiple of E; for bf16, D and F multiples of 8 and every pointer
// 16-byte aligned. Returns a cudaError_t (0 = launched).
int moe_grouped_ffn(const void* buf, const void* wg, const void* wu,
                    const void* wd, const void* counts, void* hid, void* out,
                    int G, int E, int C, int D, int F, int dtype,
                    void* stream) {
  if (G <= 0 || G > 65535 || E <= 0 || G % E != 0 || C <= 0 || D <= 0 ||
      F <= 0)
    return (int)cudaErrorInvalidValue;
  const int* cnt = static_cast<const int*>(counts);
  float* h = static_cast<float*>(hid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cc::launch(buf, wg, wu, wd, cnt, h, out, G, E, C, D, F, s);
  if (dtype == 1) {
    if (D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
    return tc::launch(buf, wg, wu, wd, cnt, h, out, G, E, C, D, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
