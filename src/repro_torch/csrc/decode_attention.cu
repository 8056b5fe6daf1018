// GQA flash-decode over a slot (ring-buffer) KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py ::
// decode_attention_kernel (pallas_call at decode_attention.py:80). Same
// contract: q [B,Hq,hd], k/v [B,Hkv,S,hd], kv_pos [B,S] int32 (absolute
// position per slot, -1 = empty), q_pos [B] int32 -> out [B,Hq,hd]; query
// head h reads KV head h / (Hq/Hkv); slot s is kept when
// 0 <= kv_pos <= q_pos and (no window or q_pos - kv_pos < window); scale
// hd^-0.5; masked scores are -1e30; sums in fp32. A row with nothing live
// (an empty or inactive slot) writes 0, as the TPU kernel does. Unlike the
// TPU wrapper it takes any S: the ragged last split is masked here. With
// `lse` it also writes each query row's log-sum-exp of its kept scaled
// scores (-1e30 where it kept none), so the outputs of several slices of
// one ring (a sequence cut over ranks) merge exactly.
//
// What bounds it on the card: device-memory bytes in principle (each
// (sequence, KV head) reads the K and V of its kept slots once, 4*g flops
// per element, far below the ~295 flops/byte balance point), but at
// serving sizes the bytes are tiny (~1 MB a call, well under a
// microsecond at full rate) and the time is latency: how many blocks run
// at once and how many dependent reads the longest one waits on.
//
// Design: split-K over slot ranges, then a combine pass, with the split
// bodies and the combine of csrc/split_attention.cuh, the same code the
// paged kernel runs (this file gives them the ring as their key source).
// The grid is (slot split x row tile, KV head, sequence); a split covers
// `sps` consecutive slots, a multiple of 16 chosen on the host from shapes
// only (S, the rows, head_dim, type: kernels/decode_attention.py `plan`):
// about a quarter of the ring, at most 128 slots at edge-6b's heads, so
// a 1024-slot ring of the slot engine runs 8 blocks per (sequence, KV
// head) where one ran before. Few large splits, not the paged kernel's
// many small ones: the combine reads every split of a ring, and a split's
// time is its dependent reads, about the same for 16 slots as for 128
// (launch/time_decode_attention.py). A split first reads its slice of
// kv_pos and works out which slots the mask keeps (the rows of a block
// share q_pos, so the mask is per slot); one that keeps none writes an
// empty partial (m = -1e30, l = 0) and exits, so an append-only cache
// that is mostly empty costs its kv_pos and a few bytes a split.
// Otherwise it brings only the kept slots' K and V rows into shared
// memory by 16-byte cp.async (the others zero-filled and masked) and runs
// the tensor-core body (mma.sync; bf16 at hd 64/128) or the CUDA-core
// body (fp32, hd 32/256). A ring is in slot order, not
// position order: a ring wrapped twice keeps position p in slot p % S, so
// no split can be skipped by position, as the paged kernel skips splits
// past a row's position. Every split writes (m, l), and the combine reads
// every split of a row, using a split's acc only where its l > 0 (l is the
// per-split flag): an empty split's acc is never written and never used.
// The pair of kernels is one launch of this function.
#include <cuda_runtime.h>

#include "split_attention.cuh"

namespace {

using split_attn::Args;

constexpr int kMaxSlots = 256;      // slots of one split

// The ring as the split bodies' key source: split s holds slots
// s*sps..(s+1)*sps-1 of the sequence's [Hkv,S] rows; slot c is kept by
// the sequence's query (every row of a block: C = 1) when its kv_pos p
// has 0 <= p <= q_pos and, under a window, q_pos - p < window.
struct RingKeys {
  static constexpr int kMeta = kMaxSlots;

  const int* kept;                  // the split's keep flags (shared)
  long long base;                   // K/V row of the split's first slot

  __device__ int begin(const Args& a, int b, int h, int s, int last,
                       int* meta) {
    kept = meta;
    const int key0 = s * a.kps;
    const int n = min(a.kps, a.nidx - key0);
    const int qp = last;                        // q_pos: C = 1
    base = ((long long)b * a.Hkv + h) * a.nidx + key0;
    if (threadIdx.x == 0) meta[kMeta] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = a.index[(size_t)b * a.nidx + key0 + i];
      const int k = p >= 0 && p <= qp && (a.window <= 0 || qp - p < a.window);
      meta[i] = k;
      if (k) atomicMax(meta + kMeta, i + 1);
    }
    __syncthreads();
    return meta[kMeta];             // one past the last kept slot; 0: none
  }
  __device__ long long row(int c) const { return kept[c] ? base + c : -1; }
  __device__ bool keep(int c, int) const { return kept[c] != 0; }
  __device__ static int splits(const Args& a, int) { return a.nsplit; }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; body: 0 = CUDA cores, 1 = tensor cores
// (bf16, hd 64/128); window <= 0 means no window. lse: null, or an fp32
// [B,Hq] that the combine fills with each row's log-sum-exp. part: an
// fp32 scratch of B*Hkv*nsplit*g*(hd+2) floats (g = Hq/Hkv);
// rows_per_tile, sps (a multiple of 16, <= 256) and nsplit =
// ceil(S / sps) from kernels/decode_attention.py `plan`. All tensors contiguous, q and k/v
// 16-byte aligned. Returns a cudaError_t (0 = launched).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_pos, const void* q_pos, void* out,
                     void* lse, void* part, int B, int Hq, int Hkv, int hd,
                     int S, int window, int rows_per_tile, int sps, int nsplit,
                     float scale, int dtype, int body, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || rows_per_tile <= 0 ||
      rows_per_tile > split_attn::kMaxRows || sps <= 0 || sps % 16 != 0 ||
      sps > kMaxSlots || nsplit != (S + sps - 1) / sps)
    return (int)cudaErrorInvalidValue;
  const int R = Hq / Hkv;
  const long long blocks =
      (long long)nsplit * ((R + rows_per_tile - 1) / rows_per_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(kv_pos),
               static_cast<const int*>(q_pos), out, static_cast<float*>(part),
               B, 1, Hq, Hkv, 1, S, sps, nsplit, rows_per_tile, window,
               scale, static_cast<float*>(lse)};
  return split_attn::run<RingKeys>(a, hd, dtype, body,
                                   static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
