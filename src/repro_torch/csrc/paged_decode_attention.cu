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
// Design: split-K over pages, then a combine pass, with the split bodies
// and the combine of csrc/split_attention.cuh (shared with the ring-cache
// decode kernel; this file gives them the page table as their key
// source). The grid is (page split x row tile, KV head, sequence); a split
// covers `pps` consecutive pages of the table, chosen on the host from
// shapes only (maxp, B, Hkv, the rows, the SM count:
// kernels/paged_attention.py `plan`), so a call has a few blocks an SM
// even though each row's length lives on the device. A split whose first
// position lies past the last query position of its rows exits at once,
// unwritten, and the combine pass reads only the splits that start at or
// before a row's position: a page table is in position order. A block
// issues all of its split's K and V rows, up to the tile's last position,
// at once by 16-byte cp.async into shared memory in their own type (-1
// entries zero-filled and masked). Bodies: tensor cores (mma.sync) for
// bf16 at hd 64/128 (every served arch), CUDA cores otherwise
// (kernels/paged_attention.py `body`).
#include <cuda_runtime.h>

#include "split_attention.cuh"

namespace {

using split_attn::Args;

constexpr int kMaxPages = 64;       // pages of one split

// The page table as the split bodies' key source: split s holds the
// table's pages s*pps..(s+1)*pps-1, key c at logical position
// s*pps*psz + c, kept by a query row at or after that position.
struct PagedKeys {
  static constexpr int kMeta = kMaxPages;

  const int* pg;                    // the split's page ids (shared)
  int key0, psz, h, Hkv;

  __device__ int begin(const Args& a, int b, int h_, int s, int last,
                       int* meta) {
    pg = meta;
    psz = a.psz;
    h = h_;
    Hkv = a.Hkv;
    key0 = s * a.kps;
    if (last < key0) return -1;                 // block-uniform
    const int pps = a.kps / a.psz;
    const int j0 = s * pps;
    const int nk = min(min(pps, a.nidx - j0) * psz, last - key0 + 1);
    const int npl = (nk + psz - 1) / psz;       // pages holding them
    for (int i = threadIdx.x; i < npl; i += blockDim.x)
      meta[i] = a.index[(size_t)b * a.nidx + j0 + i];
    __syncthreads();
    return nk;
  }
  __device__ long long row(int c) const {
    const int p = pg[c / psz];
    return p >= 0 ? ((long long)p * Hkv + h) * psz + c % psz : -1;
  }
  __device__ bool keep(int c, int rpos) const {
    return pg[c / psz] >= 0 && key0 + c <= rpos;
  }
  // splits whose first position is <= pos: the split kernel wrote each
  // of them for that row
  __device__ static int splits(const Args& a, int pos) {
    return pos < 0 ? 0 : min(a.nsplit, pos / a.kps + 1);
  }
};

int run(const void* q, const void* k_pages, const void* v_pages,
        const void* page_table, const void* q_start, void* out, void* part,
        int B, int C, int Hq, int Hkv, int hd, int psz, int maxp,
        int rows_per_tile, int pps, int nsplit, float scale, int dtype,
        int body, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || psz <= 0 || maxp <= 0 || rows_per_tile <= 0 ||
      rows_per_tile > split_attn::kMaxRows || pps <= 0 || pps > kMaxPages ||
      nsplit != (maxp + pps - 1) / pps)
    return (int)cudaErrorInvalidValue;
  const int R = C * (Hq / Hkv);
  const long long blocks =
      (long long)nsplit * ((R + rows_per_tile - 1) / rows_per_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(q_start), out,
               static_cast<float*>(part), B, C, Hq, Hkv, psz, maxp,
               pps * psz, nsplit, rows_per_tile, 0, scale, nullptr};
  return split_attn::run<PagedKeys>(a, hd, dtype, body,
                                    static_cast<cudaStream_t>(stream));
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
