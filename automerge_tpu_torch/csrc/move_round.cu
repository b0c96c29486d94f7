// Move cycle resolution by pointer doubling, for Hopper.
//
// Replaces the TPU kernel automerge_tpu/engine/move_kernels.py::
// move_round_pallas (body _move_round_kernel) and the host loop that drove
// it round by round (resolve_moves_pallas). Inputs per realm d, in the
// lane layout of automerge_tpu_torch/engine/pack.py::pack_moves:
//   nodes [D, 4, N] int32: mask, base parent slot (-1 root), cand_off,
//                          cand_cnt
//   cands [D, 3, K] int32: parent slot, prio_hi, prio_lo (ranks; PAD =
//                          INT32_MAX on padding)
// One round, for the current winner pointers ptr [N]:
//   has_i    = mask_i & ptr_i < cnt_i
//   w_i      = clamp(off_i + min(ptr_i, max(cnt_i - 1, 0)), 0, K - 1)
//   parent_i = mask_i ? (has_i ? cand_parent[w_i] : base_i) : -1
//   e_i      = has_i ? (prio_hi, prio_lo)[w_i] : (PAD, PAD)
//   then ceil(log2 N) + 1 pointer-doubling steps carry the minimum edge
//   label along each walk: after them an unresolved node's pointer lies
//   on its cycle, where the carried label is the cycle's minimum, so
//   drop_i = p_i >= 0 & has_i & e_i == label(p_i) & label(p_i).hi != PAD.
// Every step reads the PREVIOUS step's p and labels (the buffers
// ping-pong, with a barrier between steps).
//
// Two entry points share that round:
// - amt_move_round: one round, the TPU kernel's contract: out [D, 3, N]
//   = (drop, unresolved, parent) for a given ptr [D, N].
// - amt_resolve_moves: the whole fixpoint of each realm in one launch,
//   the XLA resolve_moves contract. Rounds repeat while the realm's drop
//   mask is non-empty (ptr += drop), at most K + 1 rounds; a realm with no
//   drop is at its fixpoint, so per-realm termination gives the same ptr
//   as the reference's global loop. A final round gives parent and
//   unresolved, and a block reduction the table hash
//   sum over mask of mix(mix(mix(slot + GOLD) ^ parent) ^ ptr) (uint32).
//
// What bounds it on an H100: the realm's lanes are read once (16 N + 12 K
// bytes) and the outputs written once, but each round does (steps + 2)
// dependent gathers per node, so the operations, and above all the
// barriers between steps, bound it: a latency-bound loop of small steps.
//
// Design, right and simple first: one thread block per realm, each
// thread owning nodes i = tid, tid + blockDim, ... in every phase (so a
// thread updates its own ptr without a race). The nine node arrays (ptr,
// edge label hi/lo, and p/hi/lo twice for the ping-pong) live in shared
// memory, 36 N bytes, when that fits 220 KB of the block's 227 KB
// (N <= 6,257), and in a global scratch slice per realm beyond that:
// generic pointers make both the same code. No cap on N: the TPU kernel's 512-node cap came
// from its one-hot [N, N] gathers, and here a gather is one load.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = 0x7fffffff;
constexpr int kArrays = 9;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct Lanes {
  int32_t* ptr;   // winner pointers (resolve only; the round reads global)
  int32_t* ehi;   // the node's own edge label
  int32_t* elo;
  int32_t* p[2];  // ping-pong: walk pointer and carried minimum label
  int32_t* mh[2];
  int32_t* ml[2];
};

__device__ __forceinline__ Lanes carve(int32_t* buf, int N) {
  Lanes l;
  l.ptr = buf;
  l.ehi = buf + N;
  l.elo = buf + 2 * N;
  l.p[0] = buf + 3 * N;
  l.p[1] = buf + 4 * N;
  l.mh[0] = buf + 5 * N;
  l.mh[1] = buf + 6 * N;
  l.ml[0] = buf + 7 * N;
  l.ml[1] = buf + 8 * N;
  return l;
}

struct Realm {
  const int32_t* mask;
  const int32_t* base;
  const int32_t* off;
  const int32_t* cnt;
  const int32_t* cpar;
  const int32_t* chi;
  const int32_t* clo;
  int N, K;
};

__device__ __forceinline__ Realm realm_of(const int32_t* nodes,
                                          const int32_t* cands, int d, int N,
                                          int K) {
  const int32_t* nd = nodes + static_cast<size_t>(d) * 4 * N;
  const int32_t* cd = cands + static_cast<size_t>(d) * 3 * K;
  return Realm{nd, nd + N, nd + 2 * N, nd + 3 * N, cd, cd + K, cd + 2 * K,
               N, K};
}

__device__ __forceinline__ bool has_winner(const Realm& r, int i, int ptr) {
  return r.mask[i] > 0 && ptr < r.cnt[i];
}

// Phases 1 and 2 of a round: winner gather, then the doubling steps.
// Writes the tentative parent to `parent_out[i]` when it is not null.
// Returns the index (0 or 1) of the buffers holding the final walk.
__device__ int walk(const Realm& r, const Lanes& l, const int32_t* ptr,
                    int steps, int32_t* parent_out) {
  const int N = r.N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int pi = ptr[i];
    const int c = r.cnt[i];
    const bool has = has_winner(r, i, pi);
    const int sel = min(pi, max(c - 1, 0));
    // int32 wraparound, as the reference's jnp arithmetic
    int w = static_cast<int>(static_cast<uint32_t>(r.off[i]) +
                             static_cast<uint32_t>(sel));
    w = min(max(w, 0), r.K - 1);
    int32_t parent = has ? r.cpar[w] : r.base[i];
    if (!(r.mask[i] > 0)) parent = -1;
    const int32_t eh = has ? r.chi[w] : kPad;
    const int32_t el = has ? r.clo[w] : kPad;
    l.ehi[i] = eh;
    l.elo[i] = el;
    l.p[0][i] = parent;
    l.mh[0][i] = eh;
    l.ml[0][i] = el;
    if (parent_out) parent_out[i] = parent;
  }
  __syncthreads();
  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    const int nxt = cur ^ 1;
    const int32_t* p = l.p[cur];
    const int32_t* mh = l.mh[cur];
    const int32_t* ml = l.ml[cur];
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int32_t pi = p[i];
      int32_t h = mh[i], lo = ml[i], np = -1;
      if (pi >= 0) {
        const int q = min(pi, N - 1);
        const int32_t nh = mh[q], nl = ml[q];
        if (nh < h || (nh == h && nl < lo)) {
          h = nh;
          lo = nl;
        }
        np = p[q];
      }
      l.p[nxt][i] = np;
      l.mh[nxt][i] = h;
      l.ml[nxt][i] = lo;
    }
    __syncthreads();
    cur = nxt;
  }
  return cur;
}

// Phase 3 for node i: its drop flag, from the final walk buffers.
__device__ __forceinline__ bool drop_of(const Realm& r, const Lanes& l,
                                        int cur, int i, int ptr,
                                        bool* unresolved) {
  const int32_t p = l.p[cur][i];
  *unresolved = p >= 0;
  const int a = min(max(p, 0), r.N - 1);
  const int32_t dh = l.mh[cur][a];
  const int32_t dl = l.ml[cur][a];
  return p >= 0 && has_winner(r, i, ptr) && l.ehi[i] == dh &&
         l.elo[i] == dl && dh != kPad;
}

__device__ __forceinline__ int32_t* lanes_base(int32_t* scratch, int N) {
  extern __shared__ int32_t smem[];
  return scratch ? scratch + static_cast<size_t>(blockIdx.x) * kArrays * N
                 : smem;
}

__global__ void move_round_kernel(const int32_t* __restrict__ nodes,
                                  const int32_t* __restrict__ cands,
                                  const int32_t* __restrict__ ptr_in,
                                  int32_t* __restrict__ out,
                                  int32_t* scratch, int N, int K, int steps) {
  const int d = blockIdx.x;
  const Realm r = realm_of(nodes, cands, d, N, K);
  const Lanes l = carve(lanes_base(scratch, N), N);
  const int32_t* ptr = ptr_in + static_cast<size_t>(d) * N;
  int32_t* o = out + static_cast<size_t>(d) * 3 * N;
  const int cur = walk(r, l, ptr, steps, o + 2 * N);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    bool unresolved;
    const bool drop = drop_of(r, l, cur, i, ptr[i], &unresolved);
    o[i] = drop;
    o[N + i] = unresolved;
  }
}

__global__ void resolve_moves_kernel(
    const int32_t* __restrict__ nodes, const int32_t* __restrict__ cands,
    int32_t* __restrict__ ptr_out, int32_t* __restrict__ parent_out,
    uint8_t* __restrict__ resolved_out, int32_t* __restrict__ dropped_out,
    int32_t* __restrict__ hash_out, int32_t* scratch, int N, int K,
    int steps, int max_rounds) {
  __shared__ uint32_t red[2][32];
  const int d = blockIdx.x;
  const Realm r = realm_of(nodes, cands, d, N, K);
  const Lanes l = carve(lanes_base(scratch, N), N);
  for (int i = threadIdx.x; i < N; i += blockDim.x) l.ptr[i] = 0;
  __syncthreads();

  uint32_t my_dropped = 0;
  for (int rnd = 0; rnd < max_rounds; ++rnd) {
    const int cur = walk(r, l, l.ptr, steps, nullptr);
    int my_drops = 0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      bool unresolved;
      if (drop_of(r, l, cur, i, l.ptr[i], &unresolved)) {
        l.ptr[i] += 1;  // only this thread reads or writes ptr[i]
        ++my_drops;
      }
    }
    my_dropped += my_drops;
    // also the barrier before the next round rewrites the walk buffers
    if (!__syncthreads_or(my_drops)) break;
  }

  int32_t* po = parent_out + static_cast<size_t>(d) * N;
  const int cur = walk(r, l, l.ptr, steps, po);
  uint32_t h_acc = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int32_t pi = l.ptr[i];
    bool unresolved;
    drop_of(r, l, cur, i, pi, &unresolved);
    const bool m = r.mask[i] > 0;
    ptr_out[static_cast<size_t>(d) * N + i] = pi;
    resolved_out[static_cast<size_t>(d) * N + i] = m && !unresolved;
    if (m) {
      uint32_t h = mix32(static_cast<uint32_t>(i) + 0x9E3779B9u);
      h = mix32(h ^ static_cast<uint32_t>(po[i]));
      h_acc += mix32(h ^ static_cast<uint32_t>(pi));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    h_acc += __shfl_down_sync(0xffffffffu, h_acc, o);
    my_dropped += __shfl_down_sync(0xffffffffu, my_dropped, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = h_acc;
    red[1][warp] = my_dropped;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t h = 0, n = 0;
    for (int w = 0; w < (blockDim.x >> 5); ++w) {
      h += red[0][w];
      n += red[1][w];
    }
    hash_out[d] = static_cast<int32_t>(h);
    dropped_out[d] = static_cast<int32_t>(n);
  }
}

int threads_for(int N) {
  int t = ((N + 31) / 32) * 32;
  return t > 512 ? 512 : t;
}

// Dynamic shared memory for the nine node arrays, or 0 when the caller
// passed a global scratch. Above 48 KB a kernel must opt in to the size.
template <typename Kernel>
int smem_for(Kernel kernel, int N, const int32_t* scratch) {
  if (scratch) return 0;
  const int bytes = kArrays * N * static_cast<int>(sizeof(int32_t));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return bytes;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (a cudaStream_t as a pointer) and
// return cudaGetLastError() after the launch, 0 when it was accepted.
// `scratch` is null (node arrays in shared memory: 36 N bytes, at most
// 220 KB) or a [D, 9, N] int32 device buffer. n_docs >= 1, N >= 1, K >= 1.

int amt_move_round(const int32_t* nodes, const int32_t* cands,
                   const int32_t* ptr, int32_t* out, int32_t* scratch,
                   int n_docs, int N, int K, int steps, void* stream) {
  const int smem = smem_for(move_round_kernel, N, scratch);
  if (smem < 0) return -smem;
  move_round_kernel<<<n_docs, threads_for(N), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      nodes, cands, ptr, out, scratch, N, K, steps);
  return static_cast<int>(cudaGetLastError());
}

int amt_resolve_moves(const int32_t* nodes, const int32_t* cands,
                      int32_t* ptr, int32_t* parent, uint8_t* resolved,
                      int32_t* dropped, int32_t* hash, int32_t* scratch,
                      int n_docs, int N, int K, int steps, int max_rounds,
                      void* stream) {
  const int smem = smem_for(resolve_moves_kernel, N, scratch);
  if (smem < 0) return -smem;
  resolve_moves_kernel<<<n_docs, threads_for(N), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      nodes, cands, ptr, parent, resolved, dropped, hash, scratch, N, K,
      steps, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
