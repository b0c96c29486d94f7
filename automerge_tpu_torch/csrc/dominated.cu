// Per-op causal domination flags of the docs-major engine, for Hopper.
//
// Replaces the TPU kernel automerge_tpu/engine/pallas_kernels.py::
// dominated_pallas (body _dom_kernel). Inputs, per document d of D:
// clock_op [N, A] int32 (each op's change-clock row), actor, fid, seq,
// change_idx [N] int32 and amask [N] bool. Output [N] bool:
//   out[i] = amask_i && exists j: amask_j && fid_j == fid_i
//            && change_j != change_i && clock_op[j, actor_i] >= seq_i
// An actor outside [0, A) reads a clock of 0 (the TPU kernel's one-hot of
// such an actor is all zero). The compares are int32, exact over the whole
// range; the TPU kernel contracts on the MXU in float32, exact below 2^24
// only, so the two agree on values below 2^24.
//
// What bounds it on an H100: the function reads the mask and writes the
// flag of every op (a byte each), reads fid, change, actor and seq of a
// live op, and reads a clock cell only for a live peer on the op's field
// from another change, at 3.35 TB/s. The pairwise work is one compare for
// each pair of live ops on one field, and in the engine's batches a field
// holds few ops, so bytes bound it at the main path's shapes.
//
// Design: a team of threads per document (lane_team.cuh). A document's
// live ops are compacted, by a warp ballot and a prefix count, into a tile
// in shared memory of (fid, change, 0, clock row) entries, indexed by fid:
// the clock rows of live ops are read once, contiguously, and a masked op
// is never staged. Each live op, held in registers, walks only its own
// field's entries and stops at its first dominator. At N <= 128 a team is
// one warp and eight documents share a block (the docset fleet's N is 32);
// above, a team is 128 threads, two documents a block. Measured on an H100
// against teams of 32, 64, 128 and 256, these were the fastest on the
// docset fleet (N = 32) and the text fleet (N = 512) (PERF.md). The tile
// holds a whole document when the card's shared memory allows (N * (A + 3)
// ints and its index), and is walked in turn when it does not; the mask is
// read from device memory wherever a pass asks, so no per-op state lives in
// shared memory and nothing caps N.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_team.cuh"

namespace {

using amt::PassMem;
using amt::Team;

// One document's rows (docs-major); the mask is read where a pass asks.
struct DocSrc {
  static constexpr bool kOutOfRangeReadsZero = true;
  const int32_t* clk;  // [N, A] of this document
  const int32_t* act;
  const int32_t* fid_;
  const int32_t* seq_;
  const int32_t* chg_;
  const bool* live;
  bool* out;
  int n, A;
  __device__ bool take_i(int s) const { return live[s]; }
  __device__ bool take_j(int s) const { return live[s]; }
  __device__ int32_t fid(int s) const { return fid_[s]; }
  __device__ int32_t chg(int s) const { return chg_[s]; }
  __device__ int32_t seq(int s) const { return seq_[s]; }
  __device__ int32_t actor(int s) const { return act[s]; }
  __device__ int32_t clock(int s, int a) const {
    return clk[static_cast<size_t>(s) * A + a];
  }
  __device__ void finish(int s, bool dominated) const { out[s] = dominated; }
};

// `lanes` documents a block, a team of TEAM threads each.
template <int TEAM, int MAX_LANES>
__global__ void __launch_bounds__(TEAM * MAX_LANES)
dominated_kernel(const int32_t* __restrict__ clock_op,
                 const int32_t* __restrict__ actor,
                 const int32_t* __restrict__ fid,
                 const int32_t* __restrict__ seq,
                 const int32_t* __restrict__ change,
                 const bool* __restrict__ amask, bool* __restrict__ out,
                 int n_docs, int N, int A, int lanes, int tile_ints,
                 int key_cap, int slot_shift, int team_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = static_cast<int>(threadIdx.x) / TEAM;
  const int d = blockIdx.x * lanes + team;
  if (d >= n_docs) return;  // a whole team leaves, never part of one
  int* misc;
  PassMem m;
  amt::lay_out<TEAM>(smem + static_cast<size_t>(team) * team_bytes,
                     tile_ints, key_cap, slot_shift, &misc, &m);
  Team<TEAM> t{static_cast<int>(threadIdx.x) % TEAM, team, misc};

  const size_t row = static_cast<size_t>(d) * N;
  for (int s = t.rank; s < N; s += TEAM) {
    if (!amask[row + s]) out[row + s] = false;
  }

  amt::DomPass<DocSrc> dom;
  dom.src = DocSrc{clock_op + row * A, actor + row, fid + row, seq + row,
                   change + row, amask + row, out + row, N, A};
  amt::pair_pass(t, dom, m);
}

template <int TEAM, int LANES>
int launch(const int32_t* clock_op, const int32_t* actor, const int32_t* fid,
           const int32_t* seq, const int32_t* change, const bool* amask,
           bool* out, int n_docs, int N, int A, cudaStream_t stream) {
  static int opted[amt::kMaxDevices] = {};
  amt::Launch l;
  const cudaError_t e = amt::plan_launch<TEAM>(
      reinterpret_cast<const void*>(dominated_kernel<TEAM, LANES>), opted,
      static_cast<long long>(N) * (3 + A), N, 0, 3 + A, LANES, &l);
  if (e != cudaSuccess) return static_cast<int>(e);
  dominated_kernel<TEAM, LANES>
      <<<(n_docs + l.lanes - 1) / l.lanes, TEAM * l.lanes, l.block_bytes,
         stream>>>(clock_op, actor, fid, seq, change, amask, out, n_docs, N,
                   A, l.lanes, l.plan.tile, l.plan.key_cap,
                   l.plan.slot_shift, static_cast<int>(l.plan.bytes));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as a pointer); returns
// cudaGetLastError() after the launch, 0 when it was accepted,
// cudaErrorInvalidValue when not even one clock row of A ints fits a whole
// block of the card's shared memory. All arrays are contiguous, docs-major; n_docs >= 1,
// N >= 1, A >= 1.
int amt_dominated(const int32_t* clock_op, const int32_t* actor,
                  const int32_t* fid, const int32_t* seq,
                  const int32_t* change, const bool* amask, bool* out,
                  int n_docs, int N, int A, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 128)
    return launch<32, 8>(clock_op, actor, fid, seq, change, amask, out,
                         n_docs, N, A, st);
  return launch<128, 2>(clock_op, actor, fid, seq, change, amask, out,
                        n_docs, N, A, st);
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
