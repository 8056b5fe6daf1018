// Blockwise flash attention for prompt prefill and for one prompt chunk,
// for Hopper (sm_90a). Two kernel bodies, two entry points.
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
// What bounds it on the card: a causal prefill does ~2*S*S*Hq*hd flops
// over 2*S*(Hq+2*Hkv)*hd elements moved; a chunk of C rows at offset q0
// does ~4*C*(q0+C/2)*Hq*hd flops over the same K/V. At the serving shapes
// (S or q0 of a few hundred) that is ~100 flops a byte: bytes bound it on
// the H100 (295 bf16 flops a byte at the ridge), and a block's time is its
// walk over the key tiles.
//
// Shared design. One block per (q tile, kv head, sequence). A q tile is
// rows of the kv head's [C x g] row space taken position-major (row =
// pos*g + head-in-group), so all g query heads of a position share every
// K/V tile staged in shared memory, for any g. A loop over key tiles takes
// the place of the TPU's sequential KV grid axis, from the first key any
// row of the tile may see (window) to the last (causal limit); tiles the
// band mask removes whole, such as the stale tail past the chunk, are
// never loaded. Online softmax in fp32 registers.
//
// Tensor-core body (bf16 at hd 64 and 128: every served registry arch).
// Warp-specialised: consumer warpgroups of 64 query rows and one producer
// warpgroup, of which one thread starts TMA loads of 64-key K and V tiles
// (a 4-D tensor map over (hd, Hkv, S, B) with the view's strides, 128-byte
// swizzle, out-of-bounds rows read as zeros) into a ring guarded by
// full/empty mbarriers, two stages per consumer part, so the next tile
// loads while one is computed. S = Q.K^T is one wgmma chain with Q (staged
// once per block by 16-byte loads into the swizzled layout) and K from
// shared memory; the fp32 scores are masked only on tiles that straddle
// the diagonal, the window edge or S, exponentiated, rounded to bf16 and
// fed back as the register A operand of O += P.V, with V the transposed
// (MN-major) B operand. A block is 64 query rows and two consumer
// warpgroups, each taking every other key tile and merging its softmax
// state through shared memory at the end: that halves the walk of the
// longest block, the one that sets the kernel's time when the grid fits
// one wave (one warpgroup on 64 rows, or two on 128 rows, were slower at
// the serving shapes on the H100: PERF.md §6). The producer gives up
// registers to the consumers (setmaxnreg).
//
// CUDA-core body (fp32 at any hd, bf16 at hd 32 and 256): four threads own
// one row of a 64-row tile over 32-key tiles; plain fp32 FMAs from shared
// memory. fp32 has no tensor-core path that keeps the card tests' 1e-4.
//
// The caller names the body (kernels/flash_prefill.py :: body); an entry
// point returns cudaErrorInvalidValue for a (body, dtype, hd) it was not
// built for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// Key range of the rows [row0, row0 + rows) of one block: tiles of `keys`
// from the first key any row may see to the last.
struct Walk {
  int q0, t_first, n_tiles;
};

__device__ __forceinline__ Walk key_walk(const Args& a, int b, int row0,
                                         int rows, int keys) {
  const int G = a.Hq / a.Hkv;
  const int q0 = a.q_start ? a.q_start[b] : 0;
  const int pos_lo = q0 + row0 / G;
  const int pos_hi = q0 + min(a.C * G - 1, row0 + rows - 1) / G;
  const int k_hi = a.causal ? min(a.S - 1, pos_hi) : a.S - 1;
  const int k_lo = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int t_first = k_lo / keys;
  return {q0, t_first, k_hi >= k_lo ? k_hi / keys - t_first + 1 : 0};
}

// ------------------------------------------------------ CUDA-core body

namespace cc {

constexpr int kRows = 64;          // query rows per block
constexpr int kKeys = 32;          // keys per tile
constexpr int kTPR = 4;            // threads per row
constexpr int kThreads = kRows * kTPR;
constexpr int kCols = kKeys / kTPR;  // scores per thread per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
kernel(const Args a) {
  constexpr int PER = HD / kTPR;   // numerator elements per thread
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = a.C, S = a.S, Hq = a.Hq;
  const int G = Hq / a.Hkv;
  const int causal = a.causal, window = a.window;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int q4 = tid % kTPR;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kRows][HD+1]
  float* k_s = q_s + kRows * (HD + 1);     // [kKeys][HD+1]
  float* v_s = k_s + kKeys * (HD + 1);     // [kKeys][HD]
  float* p_s = v_s + kKeys * HD;           // [kRows][kKeys+1]

  const int rows_total = C * G;
  const int row0 = blockIdx.x * kRows;
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

  const Walk w = key_walk(a, b, row0, kRows, kKeys);
  const int my_row = row0 + r;
  const bool row_ok = my_row < rows_total;
  const int my_pos = row_ok ? my_row / G : 0;      // row in the chunk
  const int my_qp = w.q0 + my_pos;                 // its absolute position
  const T* kb = k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vb = v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;

  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int t = 0; t < w.n_tiles; ++t) {
    const int kt = (w.t_first + t) * kKeys;
    __syncthreads();               // q_s loaded / previous tile consumed
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int tk = i / HD, d = i % HD;
      const int kpos = kt + tk;
      float kv = 0.f, vv = 0.f;
      if (kpos < S) {
        kv = to_f(kb[(size_t)kpos * a.k_ss + d]);
        vv = to_f(vb[(size_t)kpos * a.v_ss + d]);
      }
      k_s[tk * (HD + 1) + d] = kv;
      v_s[tk * HD + d] = vv;
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
        kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows = (long long)a.C * (a.Hq / a.Hkv);
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), a.Hkv, a.B);
  kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------- tensor-core body

namespace tc {

constexpr int kKeys = 64;          // keys per tile
constexpr uint32_t kBlock = 64 * 128;  // bytes of 64 rows x 64 bf16 columns

// 64 query rows a block; kParts consumer warpgroups, each taking every
// kParts-th key tile of the block's walk (its partial softmax state merged
// through shared memory at the end). Each part owns two stages of the K/V
// ring.
constexpr int kParts = 2;
constexpr int kThreads = (kParts + 1) * 128;
constexpr int kStages = 2 * kParts;

template <int HD>   // bytes of a 64 x HD bf16 tile
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (HD / 64) * kBlock;
}

// part 1's state for part 0: o [HD/2][128 threads], then m, l of two rows
template <int HD>
__host__ __device__ constexpr uint32_t part_bytes() {
  return (HD / 2 + 4) * 128 * 4;
}

// Q, the K ring, the V ring, part 1's state, the barriers, and room to
// align the operand tiles to 1024 bytes
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (1 + 2 * kStages) * tile_bytes<HD>() + part_bytes<HD>() +
         16 * kStages;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ CUtensorMap k_map,
       const __grid_constant__ CUtensorMap v_map, const Args a) {
  using namespace hopper;
  constexpr uint32_t kTile = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  // operand tiles on 1024-byte boundaries (the 128-byte swizzle's atom)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* sm = smem_raw + pad;
  const uint32_t q_s = raw + pad;
  const uint32_t k_s = q_s + kTile;
  const uint32_t v_s = k_s + kStages * kTile;
  const uint32_t x_off = (1 + 2 * kStages) * kTile;   // part 1's state, bytes
  const uint32_t bars = q_s + x_off + part_bytes<HD>();
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int rows_total = a.C * G;
  const int row0 = blockIdx.x * 64;
  const Walk w = key_walk(a, b, row0, 64, kKeys);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // one arrival per warp of its part
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kParts) {
    // producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (threadIdx.x == kParts * 128) {
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      for (int i = 0; i < w.n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * kTile);
        const int kt = (w.t_first + i) * kKeys;
#pragma unroll
        for (int cb = 0; cb < HD / 64; ++cb) {
          tma_load_4d(k_s + s * kTile + cb * kBlock, &k_map, full(s), cb * 64,
                      h, kt, b);
          tma_load_4d(v_s + s * kTile + cb * kBlock, &v_map, full(s), cb * 64,
                      h, kt, b);
        }
      }
    }
  } else {
    // consumer: query rows [row0, row0 + 64), key tiles part, part +
    // kParts, ... of the walk
    reg_alloc<232>();
    const int part = wg;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int qmin = w.q0 + row0 / G;
    const int qmax = w.q0 + min(row0 + 63, rows_total - 1) / G;
    const int S = a.S, causal = a.causal, window = a.window;

    // Q rows -> the swizzled K-major layout, 16 bytes a thread a step,
    // shared by the parts
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int i = part * 128 + t; i < 64 * HD / 8; i += 128 * kParts) {
      const int r = i / (HD / 8), ch = i % (HD / 8);
      const int row = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows_total) {
        const int pos = row / G, hg = row % G;
        val = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * a.C + pos) * a.Hq + (size_t)h * G + hg) * HD +
            ch * 8);
      }
      *reinterpret_cast<uint4*>(sm + (ch / 8) * kBlock + r * 128 +
                                (((ch % 8) ^ (r % 8)) * 16)) = val;
    }
    fence_proxy_async();
    named_sync(1, 128 * kParts);

    // this thread's rows ra and ra + 8, columns cq, cq + 1 of each 8
    const int ra = row0 + warp * 16 + lane / 4;
    const int qpa = w.q0 + ra / G, qpb = w.q0 + (ra + 8) / G;
    const int cq = 2 * (lane % 4);
    const float sl2 = a.scale * 1.4426950408889634f;   // exp -> exp2

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;

    for (int i = part; i < w.n_tiles; i += kParts) {
      const int s = i % kStages;
      const int kt = (w.t_first + i) * kKeys;
      mbar_wait(full(s), (i / kStages) & 1);
      const bool skip = (causal && kt > qmax) ||
                        (window > 0 && kt + kKeys - 1 < qmin - window + 1);
      if (!skip) {
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBlock + (kk % 4) * 32;
          wgmma_64x64x16_ss(sc, desc_sw128(q_s + off, 16, 1024),
                            desc_sw128(k_s + s * kTile + off, 16, 1024),
                            kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);

        // scale to the exp2 domain; mask only where the band cuts the tile
        const bool whole = kt + kKeys <= S &&
                           (!causal || kt + kKeys - 1 <= qmin) &&
                           (window <= 0 || kt >= qmax - window + 1);
        float mxa = kNegInf, mxb = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float xa = sc[4 * j + c] * sl2, xb = sc[4 * j + 2 + c] * sl2;
            if (!whole) {
              const int kp = kt + 8 * j + cq + c;
              const int da = qpa - kp, db = qpb - kp;
              if (!(kp < S && (!causal || da >= 0) &&
                    (window <= 0 || da < window)))
                xa = kNegInf;
              if (!(kp < S && (!causal || db >= 0) &&
                    (window <= 0 || db < window)))
                xb = kNegInf;
            }
            sc[4 * j + c] = xa;
            sc[4 * j + 2 + c] = xb;
            mxa = fmaxf(mxa, xa);
            mxb = fmaxf(mxb, xb);
          }
        }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          mxa = fmaxf(mxa, __shfl_xor_sync(kFull, mxa, x));
          mxb = fmaxf(mxb, __shfl_xor_sync(kFull, mxb, x));
        }
        const float mna = fmaxf(ma, mxa), mnb = fmaxf(mb, mxb);
        // a row with nothing kept yet subtracts 0, so masked scores give 0
        const float ua = mna == kNegInf ? 0.f : mna;
        const float ub = mnb == kNegInf ? 0.f : mnb;
        const float corra = exp2f(ma - ua), corrb = exp2f(mb - ub);
        ma = mna;
        mb = mnb;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pa = exp2f(sc[4 * j + c] - ua);
            const float pb = exp2f(sc[4 * j + 2 + c] - ub);
            sc[4 * j + c] = pa;
            sc[4 * j + 2 + c] = pb;
            sa += pa;
            sb += pb;
          }
        }
        la = la * corra + sa;
        lb = lb * corrb + sb;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= corra;
          o[4 * j + 1] *= corra;
          o[4 * j + 2] *= corrb;
          o[4 * j + 3] *= corrb;
        }
        // the score accumulator's layout is the A fragment's: 16 keys a step
        uint32_t pf[16];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pf[4 * kk + x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t vd = desc_sw128(v_s + s * kTile + kk * 16 * 128,
                                         kBlock, 1024);
          if constexpr (HD == 64)
            wgmma_64x64x16_rs_tb(o, pf + 4 * kk, vd);
          else
            wgmma_64x128x16_rs_tb(o, pf + 4 * kk, vd);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // part 1 hands its state to part 0 through shared memory; the
    // threads of both parts hold the same rows and columns
    float* xp = reinterpret_cast<float*>(sm + x_off);
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) xp[i * 128 + t] = o[i];
      xp[(HD / 2) * 128 + t] = ma;
      xp[(HD / 2 + 1) * 128 + t] = mb;
      xp[(HD / 2 + 2) * 128 + t] = la;
      xp[(HD / 2 + 3) * 128 + t] = lb;
    }
    named_sync(1, 128 * kParts);
    if (part != 0) return;
    const float m1a = xp[(HD / 2) * 128 + t];
    const float m1b = xp[(HD / 2 + 1) * 128 + t];
    const float mna = fmaxf(ma, m1a), mnb = fmaxf(mb, m1b);
    const float ua = mna == kNegInf ? 0.f : mna;
    const float ub = mnb == kNegInf ? 0.f : mnb;
    const float f0a = exp2f(ma - ua), f1a = exp2f(m1a - ua);
    const float f0b = exp2f(mb - ub), f1b = exp2f(m1b - ub);
    la = la * f0a + xp[(HD / 2 + 2) * 128 + t] * f1a;
    lb = lb * f0b + xp[(HD / 2 + 3) * 128 + t] * f1b;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] = o[4 * j] * f0a + xp[(4 * j) * 128 + t] * f1a;
      o[4 * j + 1] = o[4 * j + 1] * f0a + xp[(4 * j + 1) * 128 + t] * f1a;
      o[4 * j + 2] = o[4 * j + 2] * f0b + xp[(4 * j + 2) * 128 + t] * f1b;
      o[4 * j + 3] = o[4 * j + 3] * f0b + xp[(4 * j + 3) * 128 + t] * f1b;
    }

#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      la += __shfl_xor_sync(kFull, la, x);
      lb += __shfl_xor_sync(kFull, lb, x);
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = ra + 8 * hr;
      if (row < rows_total) {
        const int pos = row / G, hg = row % G;
        const float inv = 1.f / fmaxf(hr ? lb : la, 1e-30f);
        __nv_bfloat16* op =
            out + (((size_t)b * a.C + pos) * a.Hq + (size_t)h * G + hg) * HD + cq;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(op + 8 * j) =
              pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      }
    }
  }
}

// 4-D tensor map over (hd, Hkv, S, B) of a bf16 K or V view with element
// strides (head, position, batch); boxes of 64 columns x 1 head x 64
// positions.
int kv_map(CUtensorMap* map, const void* ptr, const Args& a, int hd,
           long long sh, long long ss, long long sb) {
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)a.Hkv,
                              (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, kKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  CUtensorMap km, vm;
  int e = kv_map(&km, a.k, a, HD, a.k_sh, a.k_ss, a.k_sb);
  if (e == 0) e = kv_map(&vm, a.v, a, HD, a.v_sh, a.v_ss, a.v_sb);
  if (e != 0) return e;
  constexpr size_t smem = smem_bytes<HD>();
  // set once per instantiation, not on every launch: every launch asks for
  // the same size, and a process of the port drives one card
  static const cudaError_t ce = cudaFuncSetAttribute(
      kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const long long rows = (long long)a.C * (a.Hq / a.Hkv);
  dim3 grid((unsigned)((rows + 63) / 64), a.Hkv, a.B);
  kernel<HD><<<grid, kThreads, smem, stream>>>(km, vm, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// body: 0 = CUDA cores, 1 = tensor cores. dtype: 0 = float32, 1 = bfloat16.
int run(const Args& a, int hd, int dtype, int body, void* stream) {
  if (a.B <= 0 || a.C <= 0 || a.S <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0 && dtype == 0) {
    switch (hd) {
      case 32: return cc::launch<float, 32>(a, s);
      case 64: return cc::launch<float, 64>(a, s);
      case 128: return cc::launch<float, 128>(a, s);
      case 256: return cc::launch<float, 256>(a, s);
    }
  } else if (body == 0 && dtype == 1) {
    switch (hd) {
      case 32: return cc::launch<__nv_bfloat16, 32>(a, s);
      case 256: return cc::launch<__nv_bfloat16, 256>(a, s);
    }
  } else if (body == 1 && dtype == 1) {
    if (hd == 64) return tc::launch<64>(a, s);
    if (hd == 128) return tc::launch<128>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Whole-prompt prefill, all of q/k/v/out contiguous. window <= 0 means no
// window; body and dtype as for run() above. Returns a
// cudaError_t (0 = launched).
int flash_prefill(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int Hq, int Hkv, int hd, int causal,
                  int window, float scale, int body, int dtype,
                  void* stream) {
  const long long ss = (long long)Hkv * hd, sb = ss * S;
  Args a{q, k, v, out, nullptr, B, S, S, Hq, Hkv,
         sb, ss, hd, sb, ss, hd, causal, window, scale};
  return run(a, hd, dtype, body, stream);
}

// One causal prompt chunk: q/out contiguous [B,C,Hq,hd], q_start [B]
// int32 on the device, k/v [B,S,Hkv,hd] given by element strides
// (batch, position, head), last dimension contiguous; for the tensor-core
// body the strides and base addresses must be multiples of 16 bytes.
int flash_prefill_chunk(const void* q, const void* k, const void* v,
                        void* out, const void* q_start, int B, int C, int S,
                        int Hq, int Hkv, int hd, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, int window,
                        float scale, int body, int dtype,
                        void* stream) {
  Args a{q, k, v, out, static_cast<const int*>(q_start), B, C, S, Hq, Hkv,
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 1, window, scale};
  return run(a, hd, dtype, body, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
