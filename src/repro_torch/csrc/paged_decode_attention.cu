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
// verify window; decode passes q_start = q_pos); scale hd^-0.5; a row with
// no live key writes 0 (the TPU's acc / max(l, 1e-30)); sums in fp32.
//
// What bounds it on the card: device-memory bytes in principle (each
// sequence's live K/V read once, 4*C*g flops per element, far below the
// ~295 flops/byte balance point), but at serving sizes the bytes are tiny
// (a few MB a call, ~1 us at full rate) and the time is latency: how many
// blocks run at once, how long the longest one waits on memory, and how
// long its products take behind shared-memory loads.
//
// Design: split-K over pages, then a combine pass. The grid is (page split
// x row tile, KV head, sequence); a split covers `pps` consecutive pages of
// the table, chosen on the host from shapes only (maxp, B, Hkv, the rows,
// the SM count: kernels/paged_attention.py `plan`), so a call has a few
// blocks an SM even though each row's length lives on the device. A
// split whose first position lies past the last query position of its
// rows exits at once, and the combine pass never reads it. The R = C*g
// query rows that share a KV head stay in one block (tiles of <= 64
// rows), so each page is read once for all of them; row r is query r / g
// of head h*g + r % g, read from q's layout by index arithmetic. A block
// issues all of its split's K and V rows at once by 16-byte cp.async into
// shared memory in their own type (-1 entries zero-filled and masked).
// Two split bodies, picked on the host (kernels/paged_attention.py
// `body`):
// - tensor cores, bf16 at hd 64/128 (every served arch): q staged by
//   cp.async too; each 16 query rows are taken by 4 / (row tiles of 16)
//   warps, each over every such-th 16-key block, with mma.sync m16n8k16
//   for S = Q K^T (Q fragments held in registers) and O += P V (P from
//   the score registers, rounded to bf16; V fragments by ldmatrix.trans),
//   the online softmax in registers; the warps of a row tile merge in
//   shared memory. A small group (granite-moe g = 3) pads its rows to 16,
//   which costs tensor-core work, not memory or threads.
// - CUDA cores, fp32 and the other head dims: q staged in fp32 while K
//   and V fly, scores once K has landed (V still in flight), threads
//   spread over (row, key) pairs for the scores, a warp per row for the
//   softmax and (row, 4 columns) for P V.
// Each split writes fp32 (m, l, acc) per row; the combine kernel, a thread
// per (row, 4 columns), merges a row's live splits by log-sum-exp in one
// online pass (an all-masked split has m = -1e30, l = 0 and weighs
// nothing, so no NaN) and writes out in q's type. The split and combine
// kernels are one launch of this function.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 64;        // query rows of one block (row tile)
constexpr int kMaxPages = 64;       // pages of one split
constexpr int kMaxSmem = 232448;    // H100 opt-in shared memory a block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* page_table;
  const int* q_start;
  void* out;
  float* part;                      // acc [B,Hkv,nsplit,R,hd], then
                                    // (m, l) [B,Hkv,nsplit,R,2]
  int B, C, Hq, Hkv, psz, maxp, pps, nsplit, rows_per_tile;
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

// Splits a row at position `pos` needs: those whose first position is
// <= pos (the split kernel writes each of them for that row).
__device__ __forceinline__ int live_splits(int pos, int pps, int psz,
                                           int nsplit) {
  return pos < 0 ? 0 : min(nsplit, pos / (pps * psz) + 1);
}

// CUDA-core body (fp32, and bf16 at hd 32/256): 128 threads, 256 for
// tiles of more than 32 rows.
template <typename T, int HD>
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
  const int key0 = s * a.pps * a.psz;           // the split's first
  if (last < key0) return;                      // never read by combine
  const int j0 = s * a.pps;
  const int nk = min(min(a.pps, a.maxp - j0) * a.psz, last - key0 + 1);
  const int npl = (nk + a.psz - 1) / a.psz;     // pages holding them
  const int ksplit = a.pps * a.psz;             // key capacity of a split
  const int tid = threadIdx.x, nthreads = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pg_s[kMaxPages];
  float* q_s = reinterpret_cast<float*>(smem);              // [rows][HD]
  T* k_s = reinterpret_cast<T*>(q_s + a.rows_per_tile * HD);  // [ksplit][KS]
  T* v_s = k_s + ksplit * KS;                               // [ksplit][HD]
  float* s_s = reinterpret_cast<float*>(v_s + ksplit * HD); // [rows][ksplit]

  for (int i = tid; i < npl; i += nthreads)
    pg_s[i] = a.page_table[(size_t)b * a.maxp + j0 + i];
  __syncthreads();

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  constexpr int CH = HD / VEC;                  // 16-byte chunks a key row
  for (int pass = 0; pass < 2; ++pass) {        // K, then V
    const T* src = pass ? vp : kp;
    T* dst = pass ? v_s : k_s;
    const int stride = pass ? HD : KS;
    for (int i = tid; i < npl * a.psz * CH; i += nthreads) {
      const int c = i / CH, ch = i % CH;
      const int pg = pg_s[c / a.psz];
      const size_t off =
          pg >= 0 ? (((size_t)pg * a.Hkv + h) * a.psz + c % a.psz) * HD +
                        ch * VEC
                  : 0;
      hopper::cp_async16(hopper::smem_addr(dst + c * stride + ch * VEC),
                         src + off, pg >= 0 ? 16 : 0);
    }
    hopper::cp_async_commit();
  }

  // q rows of the tile in fp32 while the pages are in flight
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < nrows * (HD / 4); i += nthreads) {
    const int rr = i / (HD / 4), d = (i % (HD / 4)) * 4;
    const int r = r0 + rr;
    store4(load4(q + (((size_t)b * a.C + r / g) * a.Hq + (size_t)h * g +
                      r % g) * HD + d),
           q_s + rr * HD + d);
  }
  hopper::cp_async_wait<1>();                   // K has landed
  __syncthreads();

  for (int i = tid; i < nrows * nk; i += nthreads) {
    const int rr = i / nk, c = i % nk;
    const int rpos = qs + (r0 + rr) / g;
    float sc = kNegInf;
    if (pg_s[c / a.psz] >= 0 && key0 + c <= rpos)
      sc = dot<HD>(q_s + rr * HD, k_s + c * KS) * a.scale;
    s_s[rr * ksplit + c] = sc;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const size_t base = (((size_t)b * a.Hkv + h) * a.nsplit + s) * R + r0;
  float* ml = a.part + (size_t)a.B * a.Hkv * a.nsplit * R * HD;
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
template <int HD>
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
  const int key0 = s * a.pps * a.psz;
  if (last < key0) return;                      // never read by combine
  const int j0 = s * a.pps;
  const int nk = min(min(a.pps, a.maxp - j0) * a.psz, last - key0 + 1);
  const int npl = (nk + a.psz - 1) / a.psz;
  const int kload = max(npl * a.psz, (nk + 15) / 16 * 16);  // rows staged
  const int kcap = (a.pps * a.psz + 15) / 16 * 16;
  const int mt = (a.rows_per_tile + 15) / 16;   // row tiles of 16
  const int kw = 4 / mt;                        // warps a row tile
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pg_s[kMaxPages];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                // [mt*16][S]
  bf16* k_s = q_s + mt * 16 * S;                            // [kcap][S]
  bf16* v_s = k_s + kcap * S;                               // [kcap][S]
  float* o_s = reinterpret_cast<float*>(v_s + kcap * S);    // [4*16][HD]
  float* ml_s = o_s + 4 * 16 * HD;                          // [4*16][2]

  for (int i = tid; i < npl; i += blockDim.x)
    pg_s[i] = a.page_table[(size_t)b * a.maxp + j0 + i];
  __syncthreads();

  // q rows (zeros past the tile), then K and V rows (zeros for -1 pages
  // and past the split's pages up to a whole 16-key block)
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int i = tid; i < mt * 16 * (HD / 8); i += blockDim.x) {
    const int rr = i / (HD / 8), ch = i % (HD / 8);
    const int r = r0 + rr;
    const bool ok = rr < nrows;
    const size_t off =
        ok ? (((size_t)b * a.C + r / g) * a.Hq + (size_t)h * g + r % g) * HD +
                 ch * 8
           : 0;
    hopper::cp_async16(hopper::smem_addr(q_s + rr * S + ch * 8), q + off,
                       ok ? 16 : 0);
  }
  for (int pass = 0; pass < 2; ++pass) {
    const bf16* src = static_cast<const bf16*>(pass ? a.v : a.k);
    bf16* dst = pass ? v_s : k_s;
    for (int i = tid; i < kload * (HD / 8); i += blockDim.x) {
      const int c = i / (HD / 8), ch = i % (HD / 8);
      const int pg = c < npl * a.psz ? pg_s[c / a.psz] : -1;
      const size_t off =
          pg >= 0 ? (((size_t)pg * a.Hkv + h) * a.psz + c % a.psz) * HD +
                        ch * 8
                  : 0;
      hopper::cp_async16(hopper::smem_addr(dst + c * S + ch * 8), src + off,
                         pg >= 0 ? 16 : 0);
    }
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int wt = warp % mt, kg = warp / mt;     // row tile, key group
  const bool computes = kg < kw;
  const int gq = lane / 4, tq = lane % 4;
  // this lane's two rows of the warp's 16 and their last kept positions
  // (-1 for rows past the tile: nothing kept)
  int rpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = wt * 16 + gq + 8 * i;
    rpos[i] = rr < nrows ? qs + (r0 + rr) / g : -1;
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
        const bool keep = kidx < nk && pg_s[kidx / a.psz] >= 0 &&
                          key0 + kidx <= rpos[e / 2];
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
  const size_t base = (((size_t)b * a.Hkv + h) * a.nsplit + s) * R + r0;
  float* ml = a.part + (size_t)a.B * a.Hkv * a.nsplit * R * HD;
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
// (KV head, sequence). A row's live splits are merged in one online pass,
// the loads of later splits independent of the running sums, so several
// are in flight at once.
template <typename T, int HD>
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
  const int ns = live_splits(a.q_start[b] + r / g, a.pps, a.psz, a.nsplit);
  float M = kNegInf, L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < ns; ++s) {
    const size_t idx = row0 + (size_t)s * R;
    const float2 sl = *reinterpret_cast<const float2*>(ml + idx * 2);
    const float4 acc = load4(a.part + idx * HD + d);
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
  store4(o, static_cast<T*>(a.out) +
                (((size_t)b * a.C + r / g) * a.Hq + (size_t)h * g + r % g) *
                    HD + d);
}

// Both bodies write the same partials; the combine pass follows either.
template <typename T, int HD>
int combine(const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int kRows = 512 / HD;
  const int R = a.C * (a.Hq / a.Hkv);
  combine_kernel<T, HD><<<dim3((R + kRows - 1) / kRows, a.Hkv, a.B), 128, 0,
                          stream>>>(a);
  return (int)cudaGetLastError();
}

dim3 split_grid(const Args& a) {
  const int R = a.C * (a.Hq / a.Hkv);
  const int tiles = (R + a.rows_per_tile - 1) / a.rows_per_tile;
  return dim3(a.nsplit * tiles, a.Hkv, a.B);
}

constexpr int kStatic = kMaxPages * sizeof(int);

template <typename T, int HD>
int launch_cc(const Args& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_cc_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem - kStatic);
  if (attr != cudaSuccess) return (int)attr;
  const int ksplit = a.pps * a.psz;
  const size_t smem = (size_t)a.rows_per_tile * HD * 4 +
                      (size_t)ksplit * (HD + VEC) * sizeof(T) +
                      (size_t)ksplit * HD * sizeof(T) +
                      (size_t)a.rows_per_tile * ksplit * 4;
  if (smem > (size_t)(kMaxSmem - kStatic)) return (int)cudaErrorInvalidValue;
  const int threads = a.rows_per_tile > 32 ? 256 : 128;
  split_cc_kernel<T, HD><<<split_grid(a), threads, smem, stream>>>(a);
  return combine<T, HD>(a, stream);
}

template <int HD>
int launch_tc(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem - kStatic);
  if (attr != cudaSuccess) return (int)attr;
  const int mt = (a.rows_per_tile + 15) / 16;
  const int kcap = (a.pps * a.psz + 15) / 16 * 16;
  const size_t smem = (size_t)(mt * 16 + 2 * kcap) * (HD + 8) * 2 +
                      (size_t)4 * 16 * (HD + 2) * 4;
  if (smem > (size_t)(kMaxSmem - kStatic)) return (int)cudaErrorInvalidValue;
  split_tc_kernel<HD><<<split_grid(a), 128, smem, stream>>>(a);
  return combine<__nv_bfloat16, HD>(a, stream);
}

template <typename T>
int dispatch_cc(int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_cc<T, 32>(a, s);
    case 64: return launch_cc<T, 64>(a, s);
    case 128: return launch_cc<T, 128>(a, s);
    case 256: return launch_cc<T, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// body: 0 = CUDA cores (fp32 or bf16, hd 32/64/128/256), 1 = tensor cores
// (bf16, hd 64/128); kernels/paged_attention.py `body` is the rule.
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* page_table, const void* q_start, void* out, void* part,
        int B, int C, int Hq, int Hkv, int hd, int psz, int maxp,
        int rows_per_tile, int pps, int nsplit, float scale, int dtype,
        int body, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || psz <= 0 || maxp <= 0 || rows_per_tile <= 0 ||
      rows_per_tile > kMaxRows || pps <= 0 || pps > kMaxPages ||
      nsplit != (maxp + pps - 1) / pps)
    return (int)cudaErrorInvalidValue;
  const int R = C * (Hq / Hkv);
  const long long blocks =
      (long long)nsplit * ((R + rows_per_tile - 1) / rows_per_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(q_start), out,
               static_cast<float*>(part), B, C, Hq, Hkv, psz, maxp, pps,
               nsplit, rows_per_tile, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 64) return launch_tc<64>(a, s);
    if (hd == 128) return launch_tc<128>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_cc<float>(hd, a, s);
  if (dtype == 1) return dispatch_cc<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; body as `run`. part: an fp32 scratch of
// B*Hkv*nsplit*R*(hd+2) floats (R = C*Hq/Hkv); rows_per_tile, pps and
// nsplit = ceil(maxp / pps) from kernels/paged_attention.py `plan`; every
// pointer 16-byte aligned. Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* q_pos, void* out, void* part, int B,
                           int Hq, int Hkv, int hd, int psz, int maxp,
                           int rows_per_tile, int pps, int nsplit,
                           float scale, int dtype, int body, void* stream) {
  return run(q, k_pages, v_pages, page_table, q_pos, out, part, B, 1, Hq,
             Hkv, hd, psz, maxp, rows_per_tile, pps, nsplit, scale, dtype,
             body, stream);
}

int paged_verify_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* q_start, void* out, void* part, int B,
                           int C, int Hq, int Hkv, int hd, int psz, int maxp,
                           int rows_per_tile, int pps, int nsplit,
                           float scale, int dtype, int body, void* stream) {
  return run(q, k_pages, v_pages, page_table, q_start, out, part, B, C, Hq,
             Hkv, hd, psz, maxp, rows_per_tile, pps, nsplit, scale, dtype,
             body, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
