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
// Design, right and simple first: one thread block per document; the
// block walks the span axis in chunks of blockDim lanes. Each chunk is one
// block-wide exclusive scan written by hand: an inclusive scan inside each
// warp with shuffles, the warp totals through shared memory, one warp
// scanning them, and a carry from chunk to chunk. Each thread keeps its
// own uint32 hash sum, reduced over the block at the end with shuffles
// and shared memory. Reads through `order` are gathers within one
// document's rows (S * 4 bytes per field), which L2 serves; later work
// can coalesce them by sorting in shared memory.

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

// blockDim.x is a multiple of 32, at most 1024.
__global__ void span_rank_hash_kernel(const int32_t* __restrict__ spans,
                                      const int32_t* __restrict__ order,
                                      int32_t* __restrict__ starts,
                                      int32_t* __restrict__ hash_out,
                                      int32_t* __restrict__ total_out,
                                      int S) {
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
  for (int base = 0; base < S; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool in = j < S;
    int col = 0;
    if (in) {
      col = ord ? ord[j] : j;
      col = min(max(col, 0), S - 1);  // a bad order never reads out of row
    }
    const bool m = in && x[kMask * s + col] > 0;
    const uint32_t vis = m ? static_cast<uint32_t>(x[kVis * s + col]) : 0u;
    const uint32_t incl = warp_inclusive_scan(vis, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t t = lane < n_warps ? warp_tot[lane] : 0u;
      warp_tot[lane] = warp_inclusive_scan(t, lane);
    }
    __syncthreads();
    const uint32_t excl =
        carry + (warp ? warp_tot[warp - 1] : 0u) + incl - vis;
    if (in) {
      st[j] = static_cast<int32_t>(m ? excl : 0u);
      if (m) {
        h += mix4(static_cast<uint32_t>(x[kOrigin * s + col]),
                  static_cast<uint32_t>(x[kStart * s + col]), vis, excl);
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

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as a pointer); returns
// cudaGetLastError() after the launch, 0 when it was accepted. `order` may
// be null (pre-sorted lanes). n_docs >= 1, S >= 1.
int amt_span_rank_hash(const int32_t* spans, const int32_t* order,
                       int32_t* starts, int32_t* hash, int32_t* total,
                       int n_docs, int S, void* stream) {
  int threads = ((S + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  span_rank_hash_kernel<<<n_docs, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      spans, order, starts, hash, total, S);
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
