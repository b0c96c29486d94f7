// Rank + hash over merged span lanes, for Hopper.
//
// Replaces the TPU kernel automerge_tpu/engine/span_kernels.py::
// span_rank_hash_pallas (body _rank_hash_kernel). Input: spans [D, 8, S]
// int32 (automerge_tpu_torch/engine/pack.py::SPAN_FIELDS: mask, origin,
// start_id, vis_len, slot, prio_elem, prio_actor, block_seq), and
// optionally order [D, S] int32, the merged order: merged position j reads
// lane order[j] (without it the lanes are pre-sorted and j reads lane j).
// Per document, over merged positions j:
//   vis_j    = mask_j > 0 ? vis_len_j : 0
//   start_j  = sum_{k < j} vis_k                 (exclusive prefix sum)
//   hash     = sum over unmasked j of mix4(origin_j, start_id_j, vis_j,
//                                         start_j)
//   total    = sum_j vis_j
// every sum wrapping in uint32, as the TPU kernel's int32 sums wrap (the
// scan and the sums run in uint32_t, so no signed overflow, and are cast
// at the end). Outputs: starts [D, S] in merged order (0 on masked lanes),
// hash [D] (uint32 bits) and total [D].
//
// What bounds it on an H100: one read of the mask (and of order) on every
// lane and of origin, start_id and vis_len on unmasked lanes, and one
// write of the starts, 12-24 bytes a lane at 3.35 TB/s; the arithmetic is
// ~40 integer operations per unmasked lane (four murmur finalizers and
// the scan), far below the card's rate. So bytes bound it.
//
// Design: two paths, picked by S (span_kernels.span_launch).
// - Small S (a fleet of small tables, S <= 1,024): one warp per document,
//   eight documents a 256-thread block, no __syncthreads at all. The warp
//   walks the span axis in chunks of 128 merged positions; each lane takes
//   four consecutive ones, so it loads `order` and stores `starts` 16
//   bytes at a time (where S % 4 == 0 and both rows are 16-byte aligned;
//   scalar loads and stores otherwise). A lane scans its four values, a
//   warp shuffle scan gives its offset, the chunk total (lane 31's
//   inclusive sum) carries to the next chunk, and a warp sum gives the
//   hash. Every sum is the same uint32 sum in another order, so the bits
//   equal the block path's.
// - Large S (one big table, the bulk merge): one thread block per
//   document, each thread taking up to eight consecutive merged positions
//   of a chunk (so up to 8,192 lanes are one chunk). Each chunk is one
//   block-wide exclusive scan: a thread's own running sum, an inclusive
//   scan inside each warp with shuffles, the warp totals through shared
//   memory, one warp scanning them, and a carry from chunk to chunk. Each
//   thread keeps its own uint32 hash sum, reduced over the block at the
//   end.
// Reads through `order` are gathers within one document's rows (S * 4
// bytes per field), which L2 serves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 8;
constexpr int kMask = 0, kOrigin = 1, kStart = 2, kVis = 3;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  uint32_t h = mix32(a + 0x9E3779B9u);
  h = mix32(h ^ b);
  h = mix32(h ^ c);
  return mix32(h ^ d);
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v,
                                                        int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kMaxPer = 8;  // merged positions a thread of the block path

// The block path: block d merges document d. blockDim.x is a multiple of
// 32, at most 1,024; each thread takes `per` (<= kMaxPer) consecutive
// merged positions of a chunk of blockDim.x * per, so a document of up to
// 8,192 lanes is one chunk: one block-wide scan, three barriers.
__global__ void span_rank_hash_kernel(const int32_t* __restrict__ spans,
                                      const int32_t* __restrict__ order,
                                      int32_t* __restrict__ starts,
                                      int32_t* __restrict__ hash_out,
                                      int32_t* __restrict__ total_out,
                                      int S, int per) {
  __shared__ uint32_t warp_tot[32];
  const int d = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t s = static_cast<size_t>(S);
  const int32_t* x = spans + static_cast<size_t>(d) * kFields * s;
  const int32_t* ord = order ? order + static_cast<size_t>(d) * s : nullptr;
  int32_t* st = starts + static_cast<size_t>(d) * s;

  uint32_t carry = 0;  // the same in every thread: sum of earlier chunks
  uint32_t h = 0;
  for (int base = 0; base < S; base += blockDim.x * per) {
    const int j0 = base + threadIdx.x * per;
    int col[kMaxPer];
    uint32_t vis[kMaxPer], excl[kMaxPer];
    bool m[kMaxPer];
    uint32_t tot = 0;
#pragma unroll
    for (int c = 0; c < kMaxPer; ++c) {
      const bool in = c < per && j0 + c < S;
      col[c] = in ? (ord ? ord[j0 + c] : j0 + c) : 0;
      col[c] = min(max(col[c], 0), S - 1);  // a bad order never reads out of row
      m[c] = in && x[kMask * s + col[c]] > 0;
      vis[c] = m[c] ? static_cast<uint32_t>(x[kVis * s + col[c]]) : 0u;
      excl[c] = tot;
      tot += vis[c];
    }
    const uint32_t incl = warp_inclusive_scan(tot, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t t = lane < n_warps ? warp_tot[lane] : 0u;
      warp_tot[lane] = warp_inclusive_scan(t, lane);
    }
    __syncthreads();
    const uint32_t off =
        carry + (warp ? warp_tot[warp - 1] : 0u) + incl - tot;
#pragma unroll
    for (int c = 0; c < kMaxPer; ++c) {
      if (c < per && j0 + c < S) {
        const uint32_t e = off + excl[c];
        st[j0 + c] = static_cast<int32_t>(m[c] ? e : 0u);
        if (m[c]) {
          h += mix4(static_cast<uint32_t>(x[kOrigin * s + col[c]]),
                    static_cast<uint32_t>(x[kStart * s + col[c]]), vis[c],
                    e);
        }
      }
    }
    carry += warp_tot[n_warps - 1];
    __syncthreads();  // warp_tot is rewritten by the next chunk
  }

  h = warp_sum(h);
  if (lane == 0) warp_tot[warp] = h;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = 0;
    for (int w = 0; w < n_warps; ++w) acc += warp_tot[w];
    hash_out[d] = static_cast<int32_t>(acc);
    total_out[d] = static_cast<int32_t>(carry);
  }
}

constexpr int kWarpDocs = 8;  // documents (warps) a block of the warp path

// The warp path: warp w of block b merges document b * kWarpDocs + w.
// VEC: S % 4 == 0 and `order` and `starts` 16-byte aligned, so a lane's
// four positions are one int4 of each row.
template <bool VEC>
__global__ void span_rank_hash_warp_kernel(const int32_t* __restrict__ spans,
                                           const int32_t* __restrict__ order,
                                           int32_t* __restrict__ starts,
                                           int32_t* __restrict__ hash_out,
                                           int32_t* __restrict__ total_out,
                                           int n_docs, int S) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpDocs + (threadIdx.x >> 5);
  if (d >= n_docs) return;  // the whole warp: no barrier follows
  const size_t s = static_cast<size_t>(S);
  const int32_t* x = spans + static_cast<size_t>(d) * kFields * s;
  const int32_t* ord = order ? order + static_cast<size_t>(d) * s : nullptr;
  int32_t* st = starts + static_cast<size_t>(d) * s;

  uint32_t carry = 0;  // the same in every lane: sum of earlier chunks
  uint32_t h = 0;
  for (int base = 0; base < S; base += 128) {
    const int j0 = base + 4 * lane;
    int col[4];
    if (VEC && ord && j0 < S) {
      const int4 o = *reinterpret_cast<const int4*>(ord + j0);
      col[0] = o.x;
      col[1] = o.y;
      col[2] = o.z;
      col[3] = o.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        col[c] = j0 + c < S ? (ord ? ord[j0 + c] : j0 + c) : 0;
    }
    uint32_t vis[4], excl[4];
    bool m[4];
    uint32_t tot = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      col[c] = min(max(col[c], 0), S - 1);  // a bad order never reads out of row
      m[c] = j0 + c < S && x[kMask * s + col[c]] > 0;
      vis[c] = m[c] ? static_cast<uint32_t>(x[kVis * s + col[c]]) : 0u;
      excl[c] = tot;
      tot += vis[c];
    }
    const uint32_t incl = warp_inclusive_scan(tot, lane);
    const uint32_t off = carry + incl - tot;
    int32_t out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t e = off + excl[c];
      out[c] = static_cast<int32_t>(m[c] ? e : 0u);
      if (m[c]) {
        h += mix4(static_cast<uint32_t>(x[kOrigin * s + col[c]]),
                  static_cast<uint32_t>(x[kStart * s + col[c]]), vis[c], e);
      }
    }
    if (VEC) {
      if (j0 < S)
        *reinterpret_cast<int4*>(st + j0) =
            make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + c < S) st[j0 + c] = out[c];
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  h = warp_sum(h);
  if (lane == 0) {
    hash_out[d] = static_cast<int32_t>(h);
    total_out[d] = static_cast<int32_t>(carry);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as a pointer); returns
// cudaGetLastError() after the launch, 0 when it was accepted. `order` may
// be null (pre-sorted lanes). `warp` (the caller's launch plan,
// span_kernels.span_launch) picks the warp path, else the block path.
// n_docs >= 1, S >= 1.
int amt_span_rank_hash(const int32_t* spans, const int32_t* order,
                       int32_t* starts, int32_t* hash, int32_t* total,
                       int n_docs, int S, int warp, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    const int blocks = (n_docs + kWarpDocs - 1) / kWarpDocs;
    const bool vec = S % 4 == 0 && aligned16(starts) &&
                     (order == nullptr || aligned16(order));
    if (vec)
      span_rank_hash_warp_kernel<true><<<blocks, 32 * kWarpDocs, 0, st>>>(
          spans, order, starts, hash, total, n_docs, S);
    else
      span_rank_hash_warp_kernel<false><<<blocks, 32 * kWarpDocs, 0, st>>>(
          spans, order, starts, hash, total, n_docs, S);
  } else {
    int threads = ((S + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    int per = (S + threads - 1) / threads;
    if (per > kMaxPer) per = kMaxPer;
    span_rank_hash_kernel<<<n_docs, threads, 0, st>>>(spans, order, starts,
                                                      hash, total, S, per);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
