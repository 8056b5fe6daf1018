// Split-K GQA attention bodies shared by the paged kernels
// (paged_decode_attention.cu) and the ring-cache decode kernel
// (decode_attention.cu): a split kernel that writes fp32 partials
// (m, l, acc) per query row for one range of keys, and a combine kernel
// that merges a row's splits by log-sum-exp. The two callers differ only
// in where key c of a split lives and which rows keep it, so the bodies
// are templated on a key source:
//
//   struct Keys {
//     static constexpr int kMeta;   // ints of shared metadata a split
//     // Block-wide, every thread: reads the split's metadata into `meta`
//     // and returns its key count nk (> 0); 0 when it keeps no key (the
//     // split then writes m = -1e30, l = 0 for its rows and exits); -1
//     // when no row reads it (it exits unwritten). `last` is the
//     // position of the tile's last query row.
//     __device__ int begin(const Args&, int b, int h, int s, int last,
//                          int* meta);
//     // K/V row of key c < nk (offset in rows of hd elements), or -1:
//     // not read, zero-filled and masked.
//     __device__ long long row(int c) const;
//     // Whether a query row at position rpos keeps key c < nk.
//     __device__ bool keep(int c, int rpos) const;
//     // How many splits, from the first, the combine reads for a row at
//     // position pos.
//     __device__ static int splits(const Args&, int pos);
//   };
//
// Layout: q and out [B,C,Hq,hd] (decode: C = 1); query row r of KV head h
// is query r / g of head h*g + r % g (g = Hq / Hkv), so the R = C*g rows
// that share a KV head stay in one block (tiles of <= 64 rows) and each
// K/V row is read once for all of them. A row's position is
// q_start[b] + r / g. Grid (split x row tile, KV head, sequence).
//
// Two split bodies, picked on the host (kernels/paged_attention.py
// `body`):
// - tensor cores, bf16 at hd 64/128: q and the split's K/V rows staged by
//   16-byte cp.async; each 16 query rows are taken by 4 / (row tiles of
//   16) warps, each over every such-th 16-key block, with mma.sync
//   m16n8k16 for S = Q K^T (Q fragments held in registers) and O += P V
//   (P from the score registers, rounded to bf16; V fragments by
//   ldmatrix.trans), the online softmax in registers; the warps of a row
//   tile merge in shared memory. A small group (g = 3) pads its rows to
//   16, which costs tensor-core work, not memory or threads.
// - CUDA cores, fp32 and the other head dims: q staged in fp32 while K
//   and V fly, scores once K has landed (V still in flight), threads
//   spread over (row, key) pairs for the scores, a warp per row for the
//   softmax and (row, 4 columns) for P V.
// The combine kernel, a thread per (row, 4 columns), merges the first
// Keys::splits(pos) splits of a row in one online pass, the loads of
// later splits independent of the running sums; a split with l = 0 (it
// kept nothing for the row) weighs nothing and its acc is not used, so an
// acc that such a split never wrote is harmless. The split and combine
// kernels are one launch of the caller's entry point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace split_attn {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 64;        // query rows of one block (row tile)
constexpr int kMaxSmem = 232448;    // H100 opt-in shared memory a block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* index;                 // paged: page table [B,maxp];
                                    // ring: kv_pos [B,S]
  const int* q_start;               // [B]: position of query 0
  void* out;
  float* part;                      // acc [B,Hkv,nsplit,R,hd], then
                                    // (m, l) [B,Hkv,nsplit,R,2]
  int B, C, Hq, Hkv;
  int psz;                          // paged: tokens a page; ring: 1
  int nidx;                         // index columns: maxp, or S
  int kps;                          // key capacity of a split
  int nsplit, rows_per_tile;
  int window;                       // ring: <= 0 none
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack(u.x), b = unpack(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float4 v, float* p) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(float4 v, __nv_bfloat16* p) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// q . k over HD, q in fp32, k a shared-memory row; 16-byte reads of k
template <int HD>
__device__ __forceinline__ float dot(const float* q, const float* k) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; d += 4) {
    const float4 a = load4(q + d), b = load4(k + d);
    s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  return s;
}
template <int HD>
__device__ __forceinline__ float dot(const float* q, const __nv_bfloat16* k) {
  float s = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(k + d);
    const float4 a = load4(q + d), b = load4(q + d + 4);
    const float2 k0 = unpack(u.x), k1 = unpack(u.y), k2 = unpack(u.z),
                 k3 = unpack(u.w);
    s += a.x * k0.x + a.y * k0.y + a.z * k1.x + a.w * k1.y + b.x * k2.x +
         b.y * k2.y + b.z * k3.x + b.w * k3.y;
  }
  return s;
}

// Offset of query row r (of KV head h, sequence b) in q and out.
__device__ __forceinline__ size_t q_row(const Args& a, int b, int h, int r,
                                        int g) {
  return ((size_t)b * a.C + r / g) * a.Hq + (size_t)h * g + r % g;
}

// An empty partial: the split keeps no key for any of its rows.
__device__ __forceinline__ void write_empty(float* ml, size_t base,
                                            int nrows) {
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    *reinterpret_cast<float2*>(ml + (base + i) * 2) =
        make_float2(kNegInf, 0.f);
}

// CUDA-core body (fp32, and bf16 at hd 32/256): 128 threads, 256 for
// tiles of more than 32 rows.
template <class Keys, typename T, int HD>
__global__ void __launch_bounds__(256)
split_cc_kernel(Args a) {
  constexpr int VEC = 16 / sizeof(T);           // elements a 16-byte copy
  constexpr int KS = HD + VEC;                  // K row stride: 16 B pad
  const int s = blockIdx.x % a.nsplit;
  const int r0 = (blockIdx.x / a.nsplit) * a.rows_per_tile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.Hq / a.Hkv;
  const int R = a.C * g;
  const int nrows = min(a.rows_per_tile, R - r0);
  if (nrows <= 0) return;                                   // block-uniform
  const int qs = a.q_start[b];
  const int last = qs + (r0 + nrows - 1) / g;   // the tile's last position
  __shared__ int meta[Keys::kMeta + 1];
  Keys keys;
  const int nk = keys.begin(a, b, h, s, last, meta);
  if (nk < 0) return;                           // never read by combine
  const size_t base = (((size_t)b * a.Hkv + h) * a.nsplit + s) * R + r0;
  float* ml = a.part + (size_t)a.B * a.Hkv * a.nsplit * R * HD;
  if (nk == 0) {
    write_empty(ml, base, nrows);
    return;
  }
  const int ksplit = a.kps;                     // key capacity of a split
  const int tid = threadIdx.x, nthreads = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);              // [rows][HD]
  T* k_s = reinterpret_cast<T*>(q_s + a.rows_per_tile * HD);  // [ksplit][KS]
  T* v_s = k_s + ksplit * KS;                               // [ksplit][HD]
  float* s_s = reinterpret_cast<float*>(v_s + ksplit * HD); // [rows][ksplit]

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  constexpr int CH = HD / VEC;                  // 16-byte chunks a key row
  for (int pass = 0; pass < 2; ++pass) {        // K, then V
    const T* src = pass ? vp : kp;
    T* dst = pass ? v_s : k_s;
    const int stride = pass ? HD : KS;
    for (int i = tid; i < nk * CH; i += nthreads) {
      const int c = i / CH, ch = i % CH;
      const long long r = keys.row(c);
      const size_t off = r >= 0 ? (size_t)r * HD + ch * VEC : 0;
      hopper::cp_async16(hopper::smem_addr(dst + c * stride + ch * VEC),
                         src + off, r >= 0 ? 16 : 0);
    }
    hopper::cp_async_commit();
  }

  // q rows of the tile in fp32 while the keys are in flight
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < nrows * (HD / 4); i += nthreads) {
    const int rr = i / (HD / 4), d = (i % (HD / 4)) * 4;
    store4(load4(q + q_row(a, b, h, r0 + rr, g) * HD + d),
           q_s + rr * HD + d);
  }
  hopper::cp_async_wait<1>();                   // K has landed
  __syncthreads();

  for (int i = tid; i < nrows * nk; i += nthreads) {
    const int rr = i / nk, c = i % nk;
    const int rpos = qs + (r0 + rr) / g;
    float sc = kNegInf;
    if (keys.keep(c, rpos))
      sc = dot<HD>(q_s + rr * HD, k_s + c * KS) * a.scale;
    s_s[rr * ksplit + c] = sc;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int rr = warp; rr < nrows; rr += nthreads / 32) {
    float* sr = s_s + rr * ksplit;
    float m = kNegInf;
    for (int c = lane; c < nk; c += 32) m = fmaxf(m, sr[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float l = 0.f;
    for (int c = lane; c < nk; c += 32) {
      const float sv = sr[c];
      const float p = sv > 0.5f * kNegInf ? expf(sv - m) : 0.f;
      sr[c] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    if (lane == 0)
      *reinterpret_cast<float2*>(ml + (base + rr) * 2) = make_float2(m, l);
  }
  hopper::cp_async_wait<0>();                   // V has landed
  __syncthreads();

  for (int i = tid; i < nrows * (HD / 4); i += nthreads) {
    const int rr = i / (HD / 4), d = (i % (HD / 4)) * 4;
    const float* pr = s_s + rr * ksplit;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nk; ++c) {
      const float p = pr[c];
      const float4 v = load4(v_s + c * HD + d);
      acc.x += p * v.x;
      acc.y += p * v.y;
      acc.z += p * v.z;
      acc.w += p * v.w;
    }
    store4(acc, a.part + (base + rr) * HD + d);
  }
}

// Tensor-core body (bf16 at hd 64 and 128): four warps stage the split;
// each 16 query rows of the tile are taken by kw = 4 / (row tiles of 16)
// warps, each over every kw-th 16-key block of the split, with mma.sync
// m16n8k16 for S = Q K^T and O += P V and the online softmax in
// registers between them; the kw warps of a row tile are merged in
// shared memory.
template <class Keys, int HD>
__global__ void __launch_bounds__(128)
split_tc_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int S = HD + 8;                     // smem row stride: 16 B pad
  const int s = blockIdx.x % a.nsplit;
  const int r0 = (blockIdx.x / a.nsplit) * a.rows_per_tile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.Hq / a.Hkv;
  const int R = a.C * g;
  const int nrows = min(a.rows_per_tile, R - r0);
  if (nrows <= 0) return;                                   // block-uniform
  const int qs = a.q_start[b];
  const int last = qs + (r0 + nrows - 1) / g;
  __shared__ int meta[Keys::kMeta + 1];
  Keys keys;
  const int nk = keys.begin(a, b, h, s, last, meta);
  if (nk < 0) return;                           // never read by combine
  const size_t base = (((size_t)b * a.Hkv + h) * a.nsplit + s) * R + r0;
  float* ml = a.part + (size_t)a.B * a.Hkv * a.nsplit * R * HD;
  if (nk == 0) {
    write_empty(ml, base, nrows);
    return;
  }
  const int kload = (nk + 15) / 16 * 16;        // rows staged
  const int kcap = (a.kps + 15) / 16 * 16;
  const int mt = (a.rows_per_tile + 15) / 16;   // row tiles of 16
  const int kw = 4 / mt;                        // warps a row tile
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                // [mt*16][S]
  bf16* k_s = q_s + mt * 16 * S;                            // [kcap][S]
  bf16* v_s = k_s + kcap * S;                               // [kcap][S]
  float* o_s = reinterpret_cast<float*>(v_s + kcap * S);    // [4*16][HD]
  float* ml_s = o_s + 4 * 16 * HD;                          // [4*16][2]

  // q rows (zeros past the tile), then K and V rows (zeros for keys not
  // read and past the split's keys up to a whole 16-key block)
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int i = tid; i < mt * 16 * (HD / 8); i += blockDim.x) {
    const int rr = i / (HD / 8), ch = i % (HD / 8);
    const bool ok = rr < nrows;
    const size_t off = ok ? q_row(a, b, h, r0 + rr, g) * HD + ch * 8 : 0;
    hopper::cp_async16(hopper::smem_addr(q_s + rr * S + ch * 8), q + off,
                       ok ? 16 : 0);
  }
  const bf16* kp = static_cast<const bf16*>(a.k);
  const bf16* vp = static_cast<const bf16*>(a.v);
  for (int i = tid; i < kload * (HD / 8); i += blockDim.x) {
    const int c = i / (HD / 8), ch = i % (HD / 8);
    const long long r = c < nk ? keys.row(c) : -1;
    const size_t off = r >= 0 ? (size_t)r * HD + ch * 8 : 0;
    const uint32_t n = r >= 0 ? 16 : 0;
    hopper::cp_async16(hopper::smem_addr(k_s + c * S + ch * 8), kp + off, n);
    hopper::cp_async16(hopper::smem_addr(v_s + c * S + ch * 8), vp + off, n);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int wt = warp % mt, kg = warp / mt;     // row tile, key group
  const bool computes = kg < kw;
  const int gq = lane / 4, tq = lane % 4;
  // this lane's two rows of the warp's 16 and their positions (-1 for
  // rows past the tile: nothing kept)
  int rpos[2];
  bool rlive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = wt * 16 + gq + 8 * i;
    rlive[i] = rr < nrows;
    rpos[i] = rlive[i] ? qs + (r0 + rr) / g : -1;
  }
  uint32_t qa[HD / 16][4];                      // A fragments of Q
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::ldmatrix_x4(
        qa[kk], hopper::smem_addr(q_s + (wt * 16 + lane % 8 +
                                         8 * ((lane / 8) % 2)) * S +
                                  kk * 16 + 8 * (lane / 16)));
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int kb = 16 * kg; computes && kb < nk; kb += 16 * kw) {
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // B fragments of K^T: matrix i is keys kb + 8(i/2).., columns
      // kk*16 + 8(i%2)..
      uint32_t kf[4];
      hopper::ldmatrix_x4(
          kf, hopper::smem_addr(k_s + (kb + lane % 8 + 8 * (lane / 16)) * S +
                                kk * 16 + 8 * ((lane / 8) % 2)));
      hopper::mma_16816(sc[0], qa[kk], kf[0], kf[1]);
      hopper::mma_16816(sc[1], qa[kk], kf[2], kf[3]);
    }
    float bm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kidx = kb + 8 * j + 2 * tq + (e & 1);
        const bool keep = rlive[e / 2] && kidx < nk &&
                          keys.keep(kidx, rpos[e / 2]);
        sc[j][e] = keep ? sc[j][e] * a.scale : kNegInf;
        bm[e / 2] = fmaxf(bm[e / 2], sc[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bm[i] = fmaxf(bm[i], __shfl_xor_sync(kFull, bm[i], 1));
      bm[i] = fmaxf(bm[i], __shfl_xor_sync(kFull, bm[i], 2));
      const float mn = fmaxf(m[i], bm[i]);
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[j][e] > 0.5f * kNegInf ? expf(sc[j][e] - m[e / 2])
                                                  : 0.f;
        sc[j][e] = p;
        l[e / 2] += p;
      }
    // P as the A fragment of a 16-key step (the score layout is the A
    // layout), rounded to bf16
    const uint32_t pa[4] = {hopper::pack_bf16(sc[0][0], sc[0][1]),
                            hopper::pack_bf16(sc[0][2], sc[0][3]),
                            hopper::pack_bf16(sc[1][0], sc[1][1]),
                            hopper::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      // B fragments of V: matrix i is keys kb + 8(i%2).., columns
      // 8(dn + i/2)..
      uint32_t vf[4];
      hopper::ldmatrix_x4_trans(
          vf, hopper::smem_addr(v_s + (kb + lane % 8 + 8 * ((lane / 8) % 2)) *
                                          S + 8 * (dn + lane / 16)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[dn][e] *= corr[e / 2];
        o[dn + 1][e] *= corr[e / 2];
      }
      hopper::mma_16816(o[dn], pa, vf[0], vf[1]);
      hopper::mma_16816(o[dn + 1], pa, vf[2], vf[3]);
    }
  }

  // each warp's state into shared memory (row wt*16 + .. of key group
  // kg at slot kg*mt + wt), then the kw groups of each row merged by
  // log-sum-exp into the split's partial
  if (computes) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      const int row = (kg * mt + wt) * 16 + gq + 8 * i;
      if (tq == 0)
        *reinterpret_cast<float2*>(ml_s + row * 2) = make_float2(m[i], l[i]);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn)
        *reinterpret_cast<float2*>(o_s + row * HD + dn * 8 + 2 * tq) =
            make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * (HD / 4); i += blockDim.x) {
    const int rr = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float M = kNegInf;
    for (int k = 0; k < kw; ++k)
      M = fmaxf(M, ml_s[(k * mt * 16 + rr) * 2]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kw; ++k) {
      const int row = k * mt * 16 + rr;
      const float w = expf(ml_s[row * 2] - M);
      const float4 v = load4(o_s + row * HD + d);
      L += ml_s[row * 2 + 1] * w;
      acc.x += v.x * w;
      acc.y += v.y * w;
      acc.z += v.z * w;
      acc.w += v.w * w;
    }
    store4(acc, a.part + (base + rr) * HD + d);
    if (d == 0)
      *reinterpret_cast<float2*>(ml + (base + rr) * 2) = make_float2(M, L);
  }
}

// One thread a (row, 4 columns): a block holds 512 / HD rows of one
// (KV head, sequence).
template <class Keys, typename T, int HD>
__global__ void __launch_bounds__(128)
combine_kernel(Args a) {
  constexpr int kRows = 512 / HD;               // rows of a block
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.Hq / a.Hkv;
  const int R = a.C * g;
  const int r = blockIdx.x * kRows + threadIdx.x / (HD / 4);
  const int d = (threadIdx.x % (HD / 4)) * 4;
  if (r >= R) return;
  const float* ml = a.part + (size_t)a.B * a.Hkv * a.nsplit * R * HD;
  const size_t row0 = ((size_t)b * a.Hkv + h) * a.nsplit * R + r;
  const int ns = Keys::splits(a, a.q_start[b] + r / g);
  float M = kNegInf, L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < ns; ++s) {
    const size_t idx = row0 + (size_t)s * R;
    const float2 sl = *reinterpret_cast<const float2*>(ml + idx * 2);
    float4 acc = load4(a.part + idx * HD + d);
    if (!(sl.y > 0.f)) acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float m = fmaxf(M, sl.x);
    const float c = expf(M - m), w = expf(sl.x - m);
    L = L * c + sl.y * w;
    o.x = o.x * c + acc.x * w;
    o.y = o.y * c + acc.y * w;
    o.z = o.z * c + acc.z * w;
    o.w = o.w * c + acc.w * w;
    M = m;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  o.x *= inv;
  o.y *= inv;
  o.z *= inv;
  o.w *= inv;
  store4(o, static_cast<T*>(a.out) + q_row(a, b, h, r, g) * HD + d);
}

// Both bodies write the same partials; the combine pass follows either.
template <class Keys, typename T, int HD>
int combine(const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int kRows = 512 / HD;
  const int R = a.C * (a.Hq / a.Hkv);
  combine_kernel<Keys, T, HD>
      <<<dim3((R + kRows - 1) / kRows, a.Hkv, a.B), 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

inline dim3 split_grid(const Args& a) {
  const int R = a.C * (a.Hq / a.Hkv);
  const int tiles = (R + a.rows_per_tile - 1) / a.rows_per_tile;
  return dim3(a.nsplit * tiles, a.Hkv, a.B);
}

// The dynamic shared memory `kernel` may use beside its static arrays,
// after raising its limit to that; -1 when either call fails.
template <typename K>
int dynamic_smem_limit(K kernel) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return -1;
  const int lim = kMaxSmem - (int)fa.sharedSizeBytes;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           lim) != cudaSuccess)
    return -1;
  return lim;
}

template <class Keys, typename T, int HD>
int launch_cc(const Args& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  static const int lim = dynamic_smem_limit(split_cc_kernel<Keys, T, HD>);
  if (lim < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.rows_per_tile * HD * 4 +
                      (size_t)a.kps * (HD + VEC) * sizeof(T) +
                      (size_t)a.kps * HD * sizeof(T) +
                      (size_t)a.rows_per_tile * a.kps * 4;
  if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
  const int threads = a.rows_per_tile > 32 ? 256 : 128;
  split_cc_kernel<Keys, T, HD><<<split_grid(a), threads, smem, stream>>>(a);
  return combine<Keys, T, HD>(a, stream);
}

template <class Keys, int HD>
int launch_tc(const Args& a, cudaStream_t stream) {
  static const int lim = dynamic_smem_limit(split_tc_kernel<Keys, HD>);
  if (lim < 0) return (int)cudaErrorInvalidValue;
  const int mt = (a.rows_per_tile + 15) / 16;
  const int kcap = (a.kps + 15) / 16 * 16;
  const size_t smem = (size_t)(mt * 16 + 2 * kcap) * (HD + 8) * 2 +
                      (size_t)4 * 16 * (HD + 2) * 4;
  if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
  split_tc_kernel<Keys, HD><<<split_grid(a), 128, smem, stream>>>(a);
  return combine<Keys, __nv_bfloat16, HD>(a, stream);
}

template <class Keys, typename T>
int dispatch_cc(int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_cc<Keys, T, 32>(a, s);
    case 64: return launch_cc<Keys, T, 64>(a, s);
    case 128: return launch_cc<Keys, T, 128>(a, s);
    case 256: return launch_cc<Keys, T, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// body: 0 = CUDA cores (fp32 or bf16, hd 32/64/128/256), 1 = tensor cores
// (bf16, hd 64/128); kernels/paged_attention.py `body` is the rule. The
// caller has checked the shapes of `a`.
template <class Keys>
int run(const Args& a, int hd, int dtype, int body, cudaStream_t s) {
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 64) return launch_tc<Keys, 64>(a, s);
    if (hd == 128) return launch_tc<Keys, 128>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_cc<Keys, float>(hd, a, s);
  if (dtype == 1) return dispatch_cc<Keys, __nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace split_attn
