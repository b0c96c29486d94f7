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
//   as the reference's global loop. Then parent and unresolved, and a
//   block reduction the table hash
//   sum over mask of mix(mix(mix(slot + GOLD) ^ parent) ^ ptr) (uint32).
//
// What bounds it on an H100: the realm's lanes are read once (16 N + 12 K
// bytes) and the outputs written once, but each round does up to
// (steps + 2) dependent gathers per node with a block barrier between
// steps, and its winner gathers are chains of two dependent device-memory
// loads. Measured by a clock per phase, a realm's block spends most of
// its time waiting on those loads and barriers, so the realm fleet's time
// follows the realms in flight on each SM. So the design cuts node steps
// and the bytes of each, keeps few registers a thread (two 512-thread
// realms an SM), issues each thread's loads before it uses them, and has
// each block prefetch its realm's lanes into L2 (a hint: no result
// depends on it).
//
// Design: one thread block per realm; thread t owns nodes
// i = t + k * blockDim (k < NPT) in every phase. What the schedule does,
// and why each point leaves the result unchanged:
// - Own state off the shared buffers. A node's walk state (p, label, and
//   whether both buffers hold it) is read and written only by its owner
//   and lives in registers (NPT nodes a thread, a template parameter); its
//   ptr, parent, edge label and flags (has, dropped, mask), used once a
//   round, sit in shared memory slots that only the owner touches. The
//   ping-pong buffers hold only what other threads gather: p and label.
// - One key for the label. (hi, lo) is carried as one unsigned key whose
//   order is the two-word order, so one compare replaces two:
//   - Wide, any labels: ((uint32)(hi ^ 0x80000000) << 32) |
//     (uint32)(lo ^ 0x80000000); flipping the sign bit maps int32 order
//     onto uint32 order and hi decides before lo, so key order and
//     equality are exactly the two-word ones; the PAD test on hi is a
//     test of the high half. p (4 bytes) and the key (8) are gathered by
//     two loads.
//   - Narrow, where a realm's labels fit: over the labels of its K
//     candidates whose hi is not PAD, code = ((hi - hmin) << lbits) |
//     (lo - lmin), lbits the bit length of lmax - lmin, when the largest
//     code is below 0xFFFFFFFF; every label whose hi is PAD codes to
//     0xFFFFFFFF. Non-PAD labels keep their order and equality, and sort
//     below every PAD-class label, as in the two-word order. Labels whose
//     hi is PAD collapse into one code, which is exact: a cycle's carried
//     minimum is PAD-class under either order exactly when it is under
//     the other, and a drop needs a non-PAD minimum. p and the code share
//     one 8-byte slot: one gather load.
// - Settled nodes. A step changes nothing for a node whose p is -1 (the
//   update needs p >= 0). Once both buffers hold such a node's state, its
//   gather and its store are skipped: whichever buffer a reader uses
//   holds the same (p, label).
// - Exact early exit. The barrier after each step is __syncthreads_or of
//   "one of my nodes has p >= 0". When no node of the realm has p >= 0,
//   every further step is the identity, so stopping gives the state the
//   full ceil(log2 N) + 1 steps give.
// - Resolved walks carry over. A node whose walk ended (p = -1) reaches
//   the root, so no node on its path is on a cycle, none of them drops,
//   and their parents and labels do not change: the next round's walk of
//   that node ends in the same state. It keeps that state (both buffers
//   hold it) and takes no step; every other node walks again from its
//   edge. A node that walks again and enters a cycle meets no carried
//   node on its way, so its pointer and label evolve as in a fresh walk.
//   Only a dropped node's winner changes, so only it gathers its winner
//   from the candidates again.
// - No repeated final walk. A round that finds no drop leaves ptr as it
//   was, so a final walk would repeat that round: its parent and
//   unresolved are the outputs. Only when the K + 1 round cap ends the
//   loop is one more walk run.
// A realm of up to 1,024 * 4 nodes (more nodes a thread spill registers)
// runs in registers and shared memory (41 bytes a node); above that the
// same schedule runs with everything in a global scratch slice per realm
// (NPT = 0): nothing caps N. The TPU kernel's 512-node cap came from its
// one-hot [N, N] gathers; here a gather is one or two loads.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = 0x7fffffff;
// Bytes a node takes: the two buffers of the wide layout (24; the narrow
// one fits in them) and its slots (17: label 8, ptr 4, parent 4, flags 1),
// in shared memory; in a scratch slice also its walk state (key 8, p 4,
// done 1) from 48 N on.
constexpr int kBufBytes = 24;
constexpr int kSmemBytes = 41;
constexpr int kHotAt = 48;
constexpr int kScratchBytes = 64;
constexpr uint8_t kHas = 1, kAgain = 2, kMask = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// A realm's lanes: two base pointers, each field at its offset.
struct Realm {
  const int32_t* nd;
  const int32_t* cd;
  int N, K;
  __device__ __forceinline__ int32_t mask(int i) const { return nd[i]; }
  __device__ __forceinline__ int32_t base(int i) const { return nd[N + i]; }
  __device__ __forceinline__ int32_t off(int i) const { return nd[2 * N + i]; }
  __device__ __forceinline__ int32_t cnt(int i) const { return nd[3 * N + i]; }
  __device__ __forceinline__ int32_t cpar(int w) const { return cd[w]; }
  __device__ __forceinline__ int32_t chi(int w) const { return cd[K + w]; }
  __device__ __forceinline__ int32_t clo(int w) const {
    return cd[2 * K + w];
  }
};

// The wide layout: the keys of both buffers (8-byte aligned), then p.
struct Wide {
  using Key = uint64_t;
  uint64_t* k_;
  int32_t* p_;
  int n;
  __device__ __forceinline__ Wide(unsigned char* at, int N)
      : k_(reinterpret_cast<uint64_t*>(at)),
        p_(reinterpret_cast<int32_t*>(k_ + 2 * N)),
        n(N) {}
  __device__ __forceinline__ Key label(int32_t hi, int32_t lo) const {
    return (static_cast<uint64_t>(static_cast<uint32_t>(hi) ^ 0x80000000u)
            << 32) |
           (static_cast<uint32_t>(lo) ^ 0x80000000u);
  }
  __device__ __forceinline__ bool is_pad(Key key) const {
    return static_cast<uint32_t>(key >> 32) ==
           (static_cast<uint32_t>(kPad) ^ 0x80000000u);
  }
  __device__ __forceinline__ void load(int b, int q, int32_t& p,
                                       Key& key) const {
    key = k_[b * n + q];
    p = p_[b * n + q];
  }
  __device__ __forceinline__ Key key(int b, int q) const {
    return k_[b * n + q];
  }
  __device__ __forceinline__ void store(int b, int i, int32_t p,
                                        Key key) const {
    k_[b * n + i] = key;
    p_[b * n + i] = p;
  }
};

// The narrow layout: one 8-byte slot (p, code) a node and buffer.
struct Narrow {
  using Key = uint32_t;
  int2* s_;
  int n;
  int32_t hmin, lmin;
  int lbits;
  __device__ __forceinline__ Narrow(unsigned char* at, int N, int32_t hmin_,
                                    int32_t lmin_, int lbits_)
      : s_(reinterpret_cast<int2*>(at)),
        n(N),
        hmin(hmin_),
        lmin(lmin_),
        lbits(lbits_) {}
  __device__ __forceinline__ Key label(int32_t hi, int32_t lo) const {
    if (hi == kPad) return 0xFFFFFFFFu;
    // hi >= hmin and lo >= lmin: the unsigned differences are exact
    return ((static_cast<uint32_t>(hi) - static_cast<uint32_t>(hmin))
            << lbits) |
           (static_cast<uint32_t>(lo) - static_cast<uint32_t>(lmin));
  }
  __device__ __forceinline__ bool is_pad(Key key) const {
    return key == 0xFFFFFFFFu;
  }
  __device__ __forceinline__ void load(int b, int q, int32_t& p,
                                       Key& key) const {
    const int2 v = s_[b * n + q];
    p = v.x;
    key = static_cast<uint32_t>(v.y);
  }
  __device__ __forceinline__ Key key(int b, int q) const {
    return static_cast<uint32_t>(s_[b * n + q].y);
  }
  __device__ __forceinline__ void store(int b, int i, int32_t p,
                                        Key key) const {
    s_[b * n + i] = make_int2(p, static_cast<int32_t>(key));
  }
};

// A node's slots, used once a round: edge label, ptr, parent, flags.
template <class Key>
struct Slots {
  Key* ekey;
  int32_t* ptr;
  int32_t* parent;
  uint8_t* flags;  // kHas | kAgain | kMask
  __device__ __forceinline__ Slots(unsigned char* at, int N)
      : ekey(reinterpret_cast<Key*>(at)),
        ptr(reinterpret_cast<int32_t*>(at + 8 * static_cast<size_t>(N))),
        parent(ptr + N),
        flags(reinterpret_cast<uint8_t*>(parent + N)) {}
};

// A node's walk state: registers (node k of this thread is
// i = tid + k * blockDim), or (NPT = 0) a scratch slice by node.
template <int NPT, class Key>
struct RegWalk {
  int32_t p_[NPT];
  Key key_[NPT];
  bool done_[NPT];
  __device__ __forceinline__ RegWalk(unsigned char*, int) {}
  __device__ __forceinline__ int32_t& p(int k, int) { return p_[k]; }
  __device__ __forceinline__ Key& key(int k, int) { return key_[k]; }
  __device__ __forceinline__ bool& done(int k, int) { return done_[k]; }
};

template <class Key>
struct GlobalWalk {
  Key* key_;
  int32_t* p_;
  bool* done_;
  __device__ __forceinline__ GlobalWalk(unsigned char* at, int N)
      : key_(reinterpret_cast<Key*>(at)),
        p_(reinterpret_cast<int32_t*>(at + 8 * static_cast<size_t>(N))),
        done_(reinterpret_cast<bool*>(p_ + N)) {}
  __device__ __forceinline__ int32_t& p(int, int i) { return p_[i]; }
  __device__ __forceinline__ Key& key(int, int i) { return key_[i]; }
  __device__ __forceinline__ bool& done(int, int i) { return done_[i]; }
};

template <int NPT, class Key>
using WalkOf = typename std::conditional<NPT == 0, GlobalWalk<Key>,
                                         RegWalk<NPT ? NPT : 1, Key>>::type;

// The owned nodes of this thread: k counts them, i is the node. With
// NPT > 0 the loop has a fixed trip count, so it unrolls and the register
// arrays stay in registers; NPT == 0 walks i over the whole realm.
#define FOR_OWNED(k, i)                                                 \
  _Pragma("unroll") for (int k = 0, i = threadIdx.x;                    \
                         NPT ? k < NPT : i < N; ++k, i += blockDim.x)   \
    if (i < N)

// Phase 1's gather, for every node of a first walk and later for the
// nodes that dropped: flags, parent and edge label into the slots, in two
// passes, the node fields (the winner index parked in the parent slot),
// then the winning candidate. Each pass is one branch-free block over the
// thread's nodes (a node past N reads node N - 1, candidate 0 stands in
// where no winner is read, and only the stores are conditional), so all
// of its loads are issued before the first is used.
template <int NPT, class Key>
__device__ __forceinline__ void gather_fields(const Realm& r,
                                              const Slots<Key>& c,
                                              bool first) {
  const int N = r.N;
#pragma unroll
  for (int k = 0, i = threadIdx.x; NPT ? k < NPT : i < N;
       ++k, i += blockDim.x) {
    const bool in = i < N;
    const int j = in ? i : N - 1;
    const uint8_t f = first ? 0 : c.flags[j];
    const int32_t m = r.mask(j), cnt = r.cnt(j), off = r.off(j);
    const int32_t base = r.base(j), pi = c.ptr[j];
    const int sel = min(pi, max(cnt - 1, 0));
    // int32 wraparound, as the reference's jnp arithmetic
    int w = static_cast<int>(static_cast<uint32_t>(off) +
                             static_cast<uint32_t>(sel));
    w = min(max(w, 0), r.K - 1);
    const bool has = m > 0 && pi < cnt;
    if (in && (first || (f & kAgain))) {
      c.flags[i] = (f & kAgain) | (has ? kHas : 0) | (m > 0 ? kMask : 0);
      c.parent[i] = has ? w : (m > 0 ? base : -1);
    }
  }
}

template <int NPT, class Buf, class Key>
__device__ __forceinline__ void gather_labels(const Realm& r, const Buf& b,
                                              const Slots<Key>& c,
                                              bool first) {
  const int N = r.N;
#pragma unroll
  for (int k = 0, i = threadIdx.x; NPT ? k < NPT : i < N;
       ++k, i += blockDim.x) {
    const bool in = i < N;
    const int j = in ? i : N - 1;
    const uint8_t f = c.flags[j];
    const bool go = in && (first || (f & kAgain));
    const bool has = f & kHas;
    const int w = go && has ? c.parent[j] : 0;
    const int32_t cp = r.cpar(w), hi = r.chi(w), lo = r.clo(w);
    if (go) {
      if (has) c.parent[i] = cp;
      c.ekey[i] = has ? b.label(hi, lo) : b.label(kPad, kPad);
    }
  }
}

// Phases 1 and 2 of a round. Phase 1: the winners (gather_fields, for a
// first walk before the label code is known, then gather_labels); a node
// whose last walk ended carries its state over, every other node starts
// again from its edge (buffer 0; both buffers if it is a root).
// Phase 2: the doubling steps. Returns the buffer index (0 or 1) that
// holds every node's final (p, key). Ends on a barrier. Inlined, so that
// the register state stays in registers.
template <int NPT, class Buf, class Walk>
__device__ __forceinline__ int walk(const Realm& r, const Buf& b,
                                    const Slots<typename Buf::Key>& c,
                                    Walk& h, int steps, bool first) {
  using Key = typename Buf::Key;
  const int N = r.N;
  if (!first) gather_fields<NPT>(r, c, false);  // a first walk's came before
  gather_labels<NPT>(r, b, c, first);
  int live = 0;
  FOR_OWNED(k, i) {
    if (!first && !(c.flags[i] & kAgain) && h.p(k, i) < 0) {
      // carried over: its walk ended
      if (!h.done(k, i)) {
        b.store(0, i, h.p(k, i), h.key(k, i));
        b.store(1, i, h.p(k, i), h.key(k, i));
        h.done(k, i) = true;
      }
      continue;
    }
    const int32_t parent = c.parent[i];
    const Key e = c.ekey[i];
    h.p(k, i) = parent;
    h.key(k, i) = e;
    b.store(0, i, parent, e);
    // a walk that ends here is settled at once: both buffers hold it
    h.done(k, i) = parent < 0;
    if (parent < 0) b.store(1, i, parent, e);
    live |= parent >= 0;
  }
  int go = __syncthreads_or(live);
  int cur = 0;
  for (int s = 0; s < steps && go; ++s) {
    const int nxt = cur ^ 1;
    live = 0;
    // Registers: every gather of this thread is issued before its first
    // store (the compiler cannot tell the two buffers apart), so their
    // latencies overlap.
    int32_t gp[NPT ? NPT : 1];
    Key gk[NPT ? NPT : 1];
    if constexpr (NPT > 0) {
      FOR_OWNED(k, i) {
        if (!h.done(k, i) && h.p(k, i) >= 0)
          b.load(cur, min(h.p(k, i), N - 1), gp[k], gk[k]);
      }
    }
    FOR_OWNED(k, i) {
      if (!h.done(k, i)) {
        int32_t p = h.p(k, i);
        Key key = h.key(k, i);
        const bool ended = p < 0;
        if (!ended) {
          Key nk;
          if constexpr (NPT > 0) {
            p = gp[k];
            nk = gk[k];
          } else {
            b.load(cur, min(p, N - 1), p, nk);
          }
          if (nk < key) key = nk;
          h.p(k, i) = p;
          h.key(k, i) = key;
        }
        // the step's result, or (ended) the second copy of a settled state
        b.store(nxt, i, p, key);
        h.done(k, i) = ended;
        live |= p >= 0;
      }
    }
    go = __syncthreads_or(live);  // also: buffer nxt complete, cur free
    cur = nxt;
  }
  return cur;
}

// Phase 3 for owned node (k, i): its drop flag, from the final buffers.
template <class Buf, class Walk>
__device__ __forceinline__ bool drop_of(const Realm& r, const Buf& b,
                                        const Slots<typename Buf::Key>& c,
                                        Walk& h, int cur, int k, int i) {
  const int32_t p = h.p(k, i);
  if (p < 0 || !(c.flags[i] & kHas)) return false;
  const typename Buf::Key d = b.key(cur, min(p, r.N - 1));
  return c.ekey[i] == d && !b.is_pad(d);
}

// The narrow code's parameters of a realm, from a block reduction over
// the labels of its K candidates whose hi is not PAD.
struct Code {
  bool narrow;
  int32_t hmin, lmin;
  int lbits;
};

__device__ __forceinline__ Code narrow_code(const Realm& r) {
  __shared__ int32_t red[4][32];
  int32_t hmin = kPad, hmax = INT32_MIN, lmin = kPad, lmax = INT32_MIN;
  // unrolled and branch-free, so that the loads of several candidates are
  // in flight at once
#pragma unroll 4
  for (int c = threadIdx.x; c < r.K; c += blockDim.x) {
    const int32_t hi = r.chi(c), lo = r.clo(c);
    const bool real = hi != kPad;
    hmin = min(hmin, real ? hi : kPad);
    hmax = max(hmax, real ? hi : INT32_MIN);
    lmin = min(lmin, real ? lo : kPad);
    lmax = max(lmax, real ? lo : INT32_MIN);
  }
  for (int o = 16; o > 0; o >>= 1) {
    hmin = min(hmin, __shfl_xor_sync(0xffffffffu, hmin, o));
    hmax = max(hmax, __shfl_xor_sync(0xffffffffu, hmax, o));
    lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
    lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = hmin;
    red[1][warp] = hmax;
    red[2][warp] = lmin;
    red[3][warp] = lmax;
  }
  __syncthreads();
  // every warp reduces the warps' partials: lane l takes warp l's
  const bool has_w = lane < static_cast<int>(blockDim.x >> 5);
  hmin = has_w ? red[0][lane] : kPad;
  hmax = has_w ? red[1][lane] : INT32_MIN;
  lmin = has_w ? red[2][lane] : kPad;
  lmax = has_w ? red[3][lane] : INT32_MIN;
  for (int o = 16; o > 0; o >>= 1) {
    hmin = min(hmin, __shfl_xor_sync(0xffffffffu, hmin, o));
    hmax = max(hmax, __shfl_xor_sync(0xffffffffu, hmax, o));
    lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
    lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
  }
  if (hmin > hmax) return Code{true, 0, 0, 0};  // no label but PAD
  const uint32_t lspan = static_cast<uint32_t>(lmax) -
                         static_cast<uint32_t>(lmin);
  const int lbits = lspan ? 32 - __clz(lspan) : 0;
  const uint64_t hspan = static_cast<uint64_t>(
      static_cast<int64_t>(hmax) - static_cast<int64_t>(hmin));
  const bool narrow = lbits < 32 && (hspan >> (32 - lbits)) == 0 &&
                      ((hspan << lbits) | lspan) < 0xFFFFFFFFull;
  return Code{narrow, hmin, lmin, lbits};
}

// This block's working memory: shared memory (NPT > 0, so that the
// compiler sees shared loads and stores), or its slice of the scratch.
template <int NPT>
__device__ __forceinline__ unsigned char* slice_of(unsigned char* scratch,
                                                   int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (NPT > 0) return smem;
  return scratch + static_cast<size_t>(blockIdx.x) * N * kScratchBytes;
}

struct RoundOut {
  int32_t* o;  // [3, N] of this realm
};

struct ResolveOut {
  int32_t *ptr, *parent;
  uint8_t* resolved;
  int32_t *dropped, *hash;
};

// One round (move_round): the walk from the given ptr, then the lanes.
template <int NPT, class Buf>
__device__ __forceinline__ void run_realm(const Realm& r, const Buf& b,
                                          unsigned char* at,
                                          const int32_t* ptr, RoundOut out,
                                          int steps, int) {
  using Key = typename Buf::Key;
  const int N = r.N;
  const Slots<Key> c(at + static_cast<size_t>(N) * kBufBytes, N);
  WalkOf<NPT, Key> h(at + static_cast<size_t>(N) * kHotAt, N);
  const int cur = walk<NPT>(r, b, c, h, steps, true);
  FOR_OWNED(k, i) {
    out.o[i] = drop_of(r, b, c, h, cur, k, i);
    out.o[N + i] = h.p(k, i) >= 0;
    out.o[2 * N + i] = c.parent[i];
  }
}

// The fixpoint (resolve_moves).
template <int NPT, class Buf>
__device__ __forceinline__ void run_realm(const Realm& r, const Buf& b,
                                          unsigned char* at, const int32_t*,
                                          ResolveOut out, int steps,
                                          int max_rounds) {
  using Key = typename Buf::Key;
  __shared__ uint32_t red[2][32];
  const int N = r.N;
  const int d = blockIdx.x;
  const Slots<Key> c(at + static_cast<size_t>(N) * kBufBytes, N);
  WalkOf<NPT, Key> h(at + static_cast<size_t>(N) * kHotAt, N);

  uint32_t my_dropped = 0;
  bool fixpoint = false;
  for (int rnd = 0; rnd < max_rounds; ++rnd) {
    const int cur = walk<NPT>(r, b, c, h, steps, rnd == 0);
    int my_drops = 0;
    FOR_OWNED(k, i) {
      const bool drop = drop_of(r, b, c, h, cur, k, i);
      const uint8_t f = c.flags[i];
      c.flags[i] = drop ? (f | kAgain) : (f & ~kAgain);
      if (drop) {
        c.ptr[i] += 1;  // only this thread reads or writes ptr[i]
        ++my_drops;
      }
    }
    my_dropped += my_drops;
    // also the barrier before the next walk rewrites the buffers
    if (!__syncthreads_or(my_drops)) {
      fixpoint = true;  // ptr unchanged: this walk is the final one
      break;
    }
  }
  if (!fixpoint) walk<NPT>(r, b, c, h, steps, false);  // the round cap

  uint32_t h_acc = 0;
  FOR_OWNED(k, i) {
    const int32_t pi = c.ptr[i];
    const int32_t par = c.parent[i];
    const bool m = c.flags[i] & kMask;
    const size_t at_i = static_cast<size_t>(d) * N + i;
    out.ptr[at_i] = pi;
    out.parent[at_i] = par;
    out.resolved[at_i] = m && h.p(k, i) < 0;
    if (m) {
      uint32_t hh = mix32(static_cast<uint32_t>(i) + 0x9E3779B9u);
      hh = mix32(hh ^ static_cast<uint32_t>(par));
      h_acc += mix32(hh ^ static_cast<uint32_t>(pi));
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
  if (warp == 0) {
    const bool has_w = lane < static_cast<int>(blockDim.x >> 5);
    uint32_t hs = has_w ? red[0][lane] : 0u, n = has_w ? red[1][lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      hs += __shfl_down_sync(0xffffffffu, hs, o);
      n += __shfl_down_sync(0xffffffffu, n, o);
    }
    if (lane == 0) {
      out.hash[d] = static_cast<int32_t>(hs);
      out.dropped[d] = static_cast<int32_t>(n);
    }
  }
}

// A realm's block: its narrow code where its labels fit, the wide layout
// otherwise (a block-uniform choice).
template <int NPT, class Out>
__device__ __forceinline__ void run_block(const int32_t* nodes,
                                          const int32_t* cands,
                                          const int32_t* ptr_in, Out out,
                                          unsigned char* scratch, int N,
                                          int K, int steps, int max_rounds) {
  const int d = blockIdx.x;
  // Into L2: this realm's lanes, so that all their lines are requested
  // at once, ahead of the dependent gathers below. A hint: no result
  // depends on it.
  {
    const char* nx = reinterpret_cast<const char*>(
        nodes + static_cast<size_t>(d) * 4 * N);
    const char* cx = reinterpret_cast<const char*>(
        cands + static_cast<size_t>(d) * 3 * K);
    for (int o = threadIdx.x * 128; o < 16 * N; o += blockDim.x * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + o));
    for (int o = threadIdx.x * 128; o < 12 * K; o += blockDim.x * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(cx + o));
  }
  const Realm r{nodes + static_cast<size_t>(d) * 4 * N,
                cands + static_cast<size_t>(d) * 3 * K, N, K};
  unsigned char* at = slice_of<NPT>(scratch, N);
  const int32_t* ptr = ptr_in ? ptr_in + static_cast<size_t>(d) * N : nullptr;
  // the first walk's node fields, which need no label code, then the code
  const Slots<uint32_t> slots(at + static_cast<size_t>(N) * kBufBytes, N);
  FOR_OWNED(k, i) slots.ptr[i] = ptr ? ptr[i] : 0;
  gather_fields<NPT>(r, slots, true);
  const Code c = narrow_code(r);
  if (c.narrow)
    run_realm<NPT>(r, Narrow(at, N, c.hmin, c.lmin, c.lbits), at, ptr, out,
                   steps, max_rounds);
  else
    run_realm<NPT>(r, Wide(at, N), at, ptr, out, steps, max_rounds);
}

template <int NPT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    move_round_kernel(const int32_t* __restrict__ nodes,
                      const int32_t* __restrict__ cands,
                      const int32_t* __restrict__ ptr_in,
                      int32_t* __restrict__ out, unsigned char* scratch,
                      int N, int K, int steps) {
  run_block<NPT>(nodes, cands, ptr_in,
                 RoundOut{out + static_cast<size_t>(blockIdx.x) * 3 * N},
                 scratch, N, K, steps, 0);
}

template <int NPT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    resolve_moves_kernel(const int32_t* __restrict__ nodes,
                         const int32_t* __restrict__ cands,
                         ResolveOut out, unsigned char* scratch, int N,
                         int K, int steps, int max_rounds) {
  run_block<NPT>(nodes, cands, nullptr, out, scratch, N, K, steps,
                 max_rounds);
}

// Dynamic shared memory for the buffers and slots, or 0 with a global
// scratch. Above 48 KB a kernel must opt in to the size.
template <typename Kernel>
int smem_for(Kernel kernel, int N, bool in_scratch) {
  if (in_scratch) return 0;
  const int bytes = kSmemBytes * N;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return bytes;
}

// The launch plan's check: a multiple of 32 threads, at most 1,024, and
// NPT nodes a thread covering the realm (NPT = 0: the scratch path).
bool plan_ok(int threads, int npt, int N, const void* scratch) {
  if (threads < 32 || threads > 1024 || threads % 32) return false;
  if (npt == 0) return scratch != nullptr;
  return scratch == nullptr && static_cast<long>(threads) * npt >= N;
}

// One launch of each kernel for a plan's instantiation.
struct RoundLaunch {
  const int32_t *nodes, *cands, *ptr;
  int32_t* out;
  unsigned char* scratch;
  int n_docs, N, K, steps, threads;
  cudaStream_t stream;
  template <int NPT, int MAXT, int MINB>
  int run() const {
    const auto kernel = move_round_kernel<NPT, MAXT, MINB>;
    const int smem = smem_for(kernel, N, NPT == 0);
    if (smem < 0) return -smem;
    kernel<<<n_docs, threads, smem, stream>>>(nodes, cands, ptr, out,
                                              scratch, N, K, steps);
    return static_cast<int>(cudaGetLastError());
  }
};

struct ResolveLaunch {
  const int32_t *nodes, *cands;
  ResolveOut out;
  unsigned char* scratch;
  int n_docs, N, K, steps, max_rounds, threads;
  cudaStream_t stream;
  template <int NPT, int MAXT, int MINB>
  int run() const {
    const auto kernel = resolve_moves_kernel<NPT, MAXT, MINB>;
    const int smem = smem_for(kernel, N, NPT == 0);
    if (smem < 0) return -smem;
    kernel<<<n_docs, threads, smem, stream>>>(nodes, cands, out, scratch,
                                              N, K, steps, max_rounds);
    return static_cast<int>(cudaGetLastError());
  }
};

// Runs the launch for the plan's (threads, npt). Up to 512 threads the
// kernel is built for two blocks an SM (at most 64 registers a thread,
// which the measured shape needs without spilling), above for one;
// cudaErrorInvalidValue for a plan outside the instantiations.
template <class Launch>
int dispatch(int threads, int npt, const Launch& l) {
  if (threads <= 512) {
    switch (npt) {
      case 1: return l.template run<1, 512, 2>();
      case 4: return l.template run<4, 512, 2>();
    }
  } else {
    switch (npt) {
      case 0: return l.template run<0, 1024, 1>();
      case 4: return l.template run<4, 1024, 1>();
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (a cudaStream_t as a pointer) and
// return cudaGetLastError() after the launch, 0 when it was accepted.
// The caller's launch plan (move_kernels.move_launch) gives `threads` and
// `npt`, the nodes a thread keeps in registers (1 or 4 with up to 512
// threads, 4 with 1,024; the buffers and slots in 41 N bytes of shared
// memory); npt = 0 (1,024 threads) runs the same schedule in
// `scratch`, a device buffer of 64 N bytes a realm. n_docs >= 1, N >= 1,
// K >= 1.

int amt_move_round(const int32_t* nodes, const int32_t* cands,
                   const int32_t* ptr, int32_t* out, void* scratch,
                   int n_docs, int N, int K, int steps, int threads, int npt,
                   void* stream) {
  if (!plan_ok(threads, npt, N, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(threads, npt,
                  RoundLaunch{nodes, cands, ptr, out,
                              static_cast<unsigned char*>(scratch), n_docs,
                              N, K, steps, threads,
                              static_cast<cudaStream_t>(stream)});
}

int amt_resolve_moves(const int32_t* nodes, const int32_t* cands,
                      int32_t* ptr, int32_t* parent, uint8_t* resolved,
                      int32_t* dropped, int32_t* hash, void* scratch,
                      int n_docs, int N, int K, int steps, int max_rounds,
                      int threads, int npt, void* stream) {
  if (!plan_ok(threads, npt, N, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(threads, npt,
                  ResolveLaunch{nodes, cands,
                                ResolveOut{ptr, parent, resolved, dropped,
                                           hash},
                                static_cast<unsigned char*>(scratch), n_docs,
                                N, K, steps, max_rounds, threads,
                                static_cast<cudaStream_t>(stream)});
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
