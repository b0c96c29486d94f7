// RGA linearization of list objects for the docs-major engine, for Hopper.
//
// Replaces no Pallas kernel: the reference computes this step in plain XLA,
// automerge_tpu/engine/kernels.py::linearize (:102-137), a lax.scan of E
// steps plus pointer doubling, vmapped over documents and lists. The port's
// plain version is kernels.linearize_plain. For each row of [R, E] columns
// (ins_mask bool, ins_elem, ins_actor, ins_parent int32) it writes elem_pos
// [R, E] int32, the reference's result:
//   1. the slots in ascending (key, actor, slot) order, key = elem where
//      the mask holds and INT32_MAX where not;
//   2. each valid slot in that order head-inserted right after its parent
//      (p = parent + 1, or 0, the head, for a negative parent) in a next
//      array of E + 1 nodes, node 0 the head and slot s at node s + 1. A
//      parent past the array is dropped on the store and clamped to E on
//      the load, as JAX's scatter and gather do;
//   3. d[v] = the nodes after v, by ceil_log2(E + 1) synchronous pointer-
//      doubling steps (detached nodes and cycles included);
//   4. elem_pos[s] = d[0] - d[s + 1] - 1, masked slots included.
//
// What bounds it on an H100: the function reads 17 bytes a slot (the mask
// byte and three int32 columns) and writes 4, at 3.35 TB/s. Step 2 as the
// reference writes it is E dependent read-modify-writes a row, a latency
// chain no thread count shortens, and a rank count of every slot against
// every slot is O(E^2). The design takes both out of the rows the engine
// builds:
//
// Causal rows. A row is causal when every live slot's parent is the head
// or a live slot of the row earlier in (key, actor, slot) order; the rows
// the engine builds from change streams are (an element's counter exceeds
// its parent's). On a causal row step 2's list is the preorder of the
// parent forest with children in descending order, so the kernel builds
// it in parallel: one compare a slot against its parent's tuple and a
// block-wide AND give the verdict; one bitonic sort by (parent node, key,
// actor, slot) puts each node's children in a contiguous run in ascending
// order (a masked slot's group is E + 2); a node's successor is its first
// child (the last of its run), else the next sibling (the entry before it
// in its run) of its nearest ancestor-or-self that has one, found by
// pointer jumping on the parent chain, else -1. No chain of E dependent
// steps is left.
//
// Other rows (random parents, parents past the array, self-loops, keys
// out of order) sort with group 0, which is the reference's (key, actor,
// slot) order, and one thread walks it as the reference does.
//
// Both paths then rank the list by synchronous pointer doubling of (next,
// distance) pairs, which stops once no pointer is left (a step with no
// live pointer changes nothing, so the result is the reference's), and a
// row with no live slot writes -1 everywhere without sorting.
//
// Launch shapes. Rows of E <= 32 run on a slice of a warp (the next power
// of two lanes, a slot a lane, several rows a warp and eight warps a
// block): the sort (128-bit records), the verdict, the jumps, the walk
// and the doubling are shuffles and ballots in registers, with only each
// slice's first-child and next-sibling tables in shared memory, and no
// block barrier. Longer rows run a block each, P the next power of two >=
// E: for P <= 4,096 an instance with P and the thread count fixed at
// compile time (32 threads at P = 64, 64 at 128 and 256, P / 4 above),
// its sort in registers (entries P / threads a thread; stages within a
// thread or a warp need no barrier, only wider ones go through shared
// memory), its loops unrolled, registers kept for as many blocks an SM as
// shared memory holds (up to 16: the text fleet's 2,048 rows of 256 in
// one wave). The sort's record is narrow, one u32 of the four fields less
// the row's live minima, where they fit 31 bits (the engine's counters and
// actor indices), else 128 bits (hi = group << 32 | key, lo = actor << 32
// | slot, sign bits flipped). The row's arrays (the records, then six
// node arrays) sit in shared memory. A row past P = 4,096, or whose
// arrays do not fit a block's shared memory, works in a global scratch
// instead: one slice a block, 1,024 threads, the sort in the slice with a
// barrier a stage, the grid capped by the caller and each block looping
// over rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int32_t kInt32Max = 0x7fffffff;
constexpr uint32_t kFlip = 0x80000000u;
constexpr int kMaxDevices = 64;
constexpr int kShortMax = 32;    // rows of E <= 32 run on a warp slice
constexpr int kShortWarps = 8;   // warps a block on the short path
constexpr int kShortSlice = 128; // ints of shared memory a short warp
constexpr int kNodeArrays = 6;   // int arrays of E + 1 on the block path
constexpr int kBlockStaticSmem = 32 * 4 * 4;  // the block path's wred

int ceil_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int ceil_log2(int n) {
  int b = 0;
  while ((1 << b) < n) ++b;
  return b > 1 ? b : 1;
}

// Bytes of one row's work area on the block path: the records (two u64
// arrays of P) and the six node arrays, to a multiple of 16.
long long work_bytes(int E) {
  const long long b = 16LL * ceil_pow2(E) + 4LL * kNodeArrays * (E + 1);
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ int parent_node(bool m, int32_t par, int E) {
  if (!m) return -1;
  const long long p = par >= 0 ? static_cast<long long>(par) + 1 : 0;
  return p > E ? E + 1 : static_cast<int>(p);  // E + 1: clamp, drop store
}

// (key, actor, slot) of a before that of b
__device__ __forceinline__ bool earlier(int32_t ka, int32_t aa, int a,
                                        int32_t kb, int32_t ab, int b) {
  return ka < kb || (ka == kb && (aa < ab || (aa == ab && a < b)));
}

__device__ __forceinline__ u64 rec_hi(uint32_t group, int32_t key) {
  return (static_cast<u64>(group) << 32) |
         (static_cast<uint32_t>(key) ^ kFlip);
}

__device__ __forceinline__ u64 rec_lo(int32_t actor, int slot) {
  return (static_cast<u64>(static_cast<uint32_t>(actor) ^ kFlip) << 32) |
         static_cast<uint32_t>(slot);
}

__device__ __forceinline__ bool rec_less(u64 ah, u64 al, u64 bh, u64 bl) {
  return ah < bh || (ah == bh && al < bl);
}

// ---------------------------------------------------------------------------
// E <= 32: a row on a slice of W lanes (W = the next power of two >= E)

template <int W>
__global__ void __launch_bounds__(kShortWarps * 32)
linearize_short(const bool* __restrict__ mask,
                const int32_t* __restrict__ elem,
                const int32_t* __restrict__ actor,
                const int32_t* __restrict__ parent,
                int32_t* __restrict__ out, int R, int E, int steps) {
  __shared__ int32_t tables[kShortWarps][kShortSlice];
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int l = lane & (W - 1);
  const int slice = lane / W;
  const unsigned smask =
      W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (slice * W);
  const long long r =
      (static_cast<long long>(blockIdx.x) * kShortWarps + warp) * (32 / W) +
      slice;
  if (r >= R) return;  // the whole slice
  int32_t* fc = &tables[warp][slice * 2 * (W + 1)];  // first child, by node
  int32_t* ns = fc + (W + 1);                        // next sibling, by slot

  const size_t at = static_cast<size_t>(r) * E + l;
  const bool in = l < E;
  const bool m = in && mask[at];
  const int32_t el = in ? elem[at] : 0;  // every load issued before a use
  const int32_t act = in ? actor[at] : 0;
  const int32_t par = in ? parent[at] : -1;
  const int32_t key = m ? el : kInt32Max;
  const int p = parent_node(m, par, E);
  if (!(__ballot_sync(smask, m) & smask)) {
    if (in) out[at] = -1;
    return;
  }

  // the verdict: the parent's tuple from its lane
  const int q = p >= 1 && p <= E ? p - 1 : 0;
  const int32_t qk = __shfl_sync(smask, key, q, W);
  const int32_t qa = __shfl_sync(smask, act, q, W);
  const int qm = __shfl_sync(smask, static_cast<int>(m), q, W);
  const bool ok = !m || p == 0 || (p <= E && qm && earlier(qk, qa, q, key,
                                                           act, l));
  const bool causal = !(__ballot_sync(smask, !ok) & smask);

  // bitonic sort of the records across the slice
  u64 hi = ~0ull, lo = ~0ull;
  if (in) {
    hi = rec_hi(causal ? static_cast<uint32_t>(m ? p : E + 2) : 0u, key);
    lo = rec_lo(act, l);
  }
#pragma unroll
  for (int k = 2; k <= W; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 oh = __shfl_xor_sync(smask, hi, j, W);
      const u64 ol = __shfl_xor_sync(smask, lo, j, W);
      const bool take_min = ((l & j) == 0) == ((l & k) == 0);
      if (rec_less(oh, ol, hi, lo) == take_min) {
        hi = oh;
        lo = ol;
      }
    }
  }
  const int si = static_cast<int>(static_cast<uint32_t>(lo));  // entry l

  int32_t nxt = -1, nxt0 = -1;  // node l + 1's successor; the head's
  if (causal) {
    for (int v = l; v <= E; v += W) fc[v] = -1;
    if (in) ns[l] = -1;
    __syncwarp(smask);
    const int g = static_cast<int>(hi >> 32);
    const int pg = __shfl_up_sync(smask, g, 1, W);
    const int pu = __shfl_up_sync(smask, si + 1, 1, W);
    const int ng = __shfl_down_sync(smask, g, 1, W);
    if (hi != ~0ull && g <= E) {  // a live slot's entry
      if (l > 0 && pg == g) ns[si] = pu;
      if (l == W - 1 || ng != g) fc[g] = si + 1;
    }
    __syncwarp(smask);
    const int my_ns = in ? ns[l] : -1;
    const int my_fc = in ? fc[l + 1] : -1;
    nxt0 = fc[0];
    // nearest ancestor-or-self with a next sibling (0: none, the head)
    int f = m ? (my_ns >= 0 ? l + 1 : p) : 0;
    for (;;) {
      const int ff = __shfl_sync(smask, f, f > 0 ? f - 1 : 0, W);
      const int nf = f > 0 ? ff : 0;
      const bool moved = nf != f;
      f = nf;
      if (!(__ballot_sync(smask, moved) & smask)) break;
    }
    const int sib = __shfl_sync(smask, my_ns, f > 0 ? f - 1 : 0, W);
    nxt = m ? (my_fc >= 0 ? my_fc : (f > 0 ? sib : -1)) : -1;
  } else {
    // the walk, every lane in step: entry t's slot and parent broadcast
    const int sp = __shfl_sync(smask, p, si >= 0 && si < E ? si : 0, W);
    for (int t = 0; t < E; ++t) {
      const int slot = __shfl_sync(smask, si, t, W);
      const int pt = __shfl_sync(smask, sp, t, W);
      if (pt < 0) continue;
      const int node = slot + 1;
      const int ld = pt > E ? E : pt;
      const int sv = __shfl_sync(smask, nxt, ld > 0 ? ld - 1 : 0, W);
      const int succ = ld > 0 ? sv : nxt0;
      if (l == node - 1) nxt = succ;
      if (pt == 0) {
        nxt0 = node;
      } else if (pt <= E && l == pt - 1) {
        nxt = node;
      }
    }
  }

  // doubling; a successor is a node >= 1, in lane node - 1
  int d = nxt >= 0, d0 = nxt0 >= 0;
  bool any = (__ballot_sync(smask, nxt >= 0) & smask) || nxt0 >= 0;
  for (int k = 0; k < steps && any; ++k) {
    const int src = nxt > 0 ? nxt - 1 : 0;
    const int src0 = nxt0 > 0 ? nxt0 - 1 : 0;
    const int dn = __shfl_sync(smask, d, src, W);
    const int nn = __shfl_sync(smask, nxt, src, W);
    const int dn0 = __shfl_sync(smask, d, src0, W);
    const int nn0 = __shfl_sync(smask, nxt, src0, W);
    if (nxt >= 0) {
      d += dn;
      nxt = nn;
    }
    if (nxt0 >= 0) {
      d0 += dn0;
      nxt0 = nn0;
    }
    any = (__ballot_sync(smask, nxt >= 0) & smask) || nxt0 >= 0;
  }
  if (in) out[at] = d0 - d - 1;
}

// ---------------------------------------------------------------------------
// E > 32: a row a block

// A sort record. Wide: hi = group << 32 | key, lo = actor << 32 | slot,
// sign bits flipped, any row. Narrow: one u32 of the same four fields,
// each less its row's minimum and in as many bits as the row needs, for a
// row where they fit 31 bits (the rows the engine builds: counters and
// actor indices of one list): a quarter of the shuffles and compares.
struct Wide {
  u64 h, l;
};
struct Narrow {
  uint32_t v;
};

__device__ __forceinline__ bool less(Wide a, Wide b) {
  return rec_less(a.h, a.l, b.h, b.l);
}
__device__ __forceinline__ bool less(Narrow a, Narrow b) { return a.v < b.v; }
__device__ __forceinline__ Wide shfl_xor(Wide a, int lanes) {
  return {__shfl_xor_sync(0xffffffffu, a.h, lanes),
          __shfl_xor_sync(0xffffffffu, a.l, lanes)};
}
__device__ __forceinline__ Narrow shfl_xor(Narrow a, int lanes) {
  return {__shfl_xor_sync(0xffffffffu, a.v, lanes)};
}

// How a row's records are coded: the narrow code's shifts and minima.
struct Code {
  int gshift, kshift, ashift;  // field offsets (slot at bit 0)
  int32_t kmin, amin;
  uint32_t smask;              // the slot field
};

__device__ __forceinline__ void encode(Wide& r, int g, bool m, int32_t key,
                                       int32_t act, int s, const Code&) {
  r.h = rec_hi(static_cast<uint32_t>(g), m ? key : kInt32Max);
  r.l = rec_lo(act, s);
}
__device__ __forceinline__ void encode(Narrow& r, int g, bool m, int32_t key,
                                       int32_t act, int s, const Code& c) {
  // a masked slot's key and actor do not order anything: fields 0
  r.v = (static_cast<uint32_t>(g) << c.gshift) |
        (m ? ((static_cast<uint32_t>(key) - static_cast<uint32_t>(c.kmin))
              << c.kshift) |
                 ((static_cast<uint32_t>(act) - static_cast<uint32_t>(c.amin))
                  << c.ashift)
           : 0u) |
        static_cast<uint32_t>(s);
}
__device__ __forceinline__ void pad(Wide& r) { r.h = r.l = ~0ull; }
__device__ __forceinline__ void pad(Narrow& r) { r.v = ~0u; }
__device__ __forceinline__ int slot_of(Wide r, const Code&) {
  return static_cast<int>(static_cast<uint32_t>(r.l));
}
__device__ __forceinline__ int slot_of(Narrow r, const Code& c) {
  return static_cast<int>(r.v & c.smask);
}
__device__ __forceinline__ int group_of(Wide r, const Code&) {
  return static_cast<int>(r.h >> 32);
}
__device__ __forceinline__ int group_of(Narrow r, const Code& c) {
  return static_cast<int>(r.v >> c.gshift);
}

template <class Rec>
__device__ __forceinline__ void keep(Rec& a, Rec b, bool take_min) {
  if (less(b, a) == take_min) a = b;
}

// One stage of the bitonic sort between a thread's own entries x + i and
// x + i + J (J < EPT): ascending where bit k of the entry is clear.
template <int J, int EPT, class Rec>
__device__ __forceinline__ void sort_in_thread(Rec (&r)[EPT], int x, int k) {
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    if ((i & J) == 0 && less(r[i + J], r[i]) == (((x + i) & k) == 0)) {
      const Rec t = r[i];
      r[i] = r[i + J];
      r[i + J] = t;
    }
  }
}

template <class Rec>
__device__ __forceinline__ void make_rec(Rec& r, int s, const int32_t* key,
                                         const int32_t* act,
                                         const int32_t* pv, bool causal,
                                         const Code& c, int E) {
  // group: the parent node on a causal row (E + 2 masked), else 0
  if (s < E) {
    const int p = pv[s];
    encode(r, causal ? (p >= 0 ? p : E + 2) : 0, p >= 0, key[s], act[s], s,
           c);
  } else {
    pad(r);
  }
}

// The row's records sorted, then each entry's slot and group written to
// sslot, sgroup [E] (the padding entries, last, are not). Thread t holds
// entries t * EPT + i in registers, every stage unrolled: a stage whose
// partner is in the thread (j < EPT) compares registers, one whose partner
// is in the warp (j < 32 * EPT) exchanges by shuffles, a wider one goes
// through buf.
template <class Rec, int P, int T>
__device__ __forceinline__ void sort_in_registers(
    Rec* buf, int32_t* sslot, int32_t* sgroup, const int32_t* key,
    const int32_t* act, const int32_t* pv, bool causal, const Code& c,
    int E) {
  constexpr int EPT = P / T;
  const int x = static_cast<int>(threadIdx.x) * EPT;
  Rec r[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) make_rec(r[i], x + i, key, act, pv, causal,
                                         c, E);
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool take_min = ((x & j) == 0) == ((x & k) == 0);
      if (j >= 32 * EPT) {
#pragma unroll
        for (int i = 0; i < EPT; ++i) buf[x + i] = r[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < EPT; ++i) keep(r[i], buf[(x + i) ^ j], take_min);
        __syncthreads();
      } else if (j >= EPT) {
#pragma unroll
        for (int i = 0; i < EPT; ++i)
          keep(r[i], shfl_xor(r[i], j / EPT), take_min);
      } else if (j == 1) {
        sort_in_thread<1>(r, x, k);
      } else if (j == 2) {
        if constexpr (EPT > 2) sort_in_thread<2>(r, x, k);
      } else {
        if constexpr (EPT > 4) sort_in_thread<4>(r, x, k);
      }
    }
  }
  __syncthreads();  // every key and actor read before sslot takes them
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    if (x + i < E) {
      sslot[x + i] = slot_of(r[i], c);
      sgroup[x + i] = group_of(r[i], c);
    }
  }
  __syncthreads();
}

// The same for any P: the whole bitonic sort in buf, a barrier a stage.
template <class Rec>
__device__ __forceinline__ void sort_in_buffer(
    Rec* buf, int32_t* sslot, int32_t* sgroup, const int32_t* key,
    const int32_t* act, const int32_t* pv, bool causal, const Code& c, int E,
    int P) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  for (int s = tid; s < P; s += nt) make_rec(buf[s], s, key, act, pv, causal,
                                             c, E);
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P / 2; i += nt) {
        const int a = 2 * i - (i & (j - 1));
        const int b = a + j;
        const Rec ra = buf[a], rb = buf[b];
        if (less(rb, ra) == ((a & k) == 0)) {
          buf[a] = rb;
          buf[b] = ra;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < E; i += nt) {
    sslot[i] = slot_of(buf[i], c);
    sgroup[i] = group_of(buf[i], c);
  }
  __syncthreads();
}

__device__ __forceinline__ int bits_of(uint32_t x) {
  return x ? 32 - __clz(x) : 0;
}

// A row a block. kP > 0: rows with P (the next power of two >= E) = kP, on
// kT threads, each loop's trip count and the sort's stages fixed at
// compile time, registers kept for kMinB blocks an SM (as many as shared
// memory holds, up to 16), the work area in shared memory. kP = 0: rows
// past P = 4,096, 1,024 threads, the work area in the global scratch and
// the sort in it. Each instance knows its work area's space.
template <int kP, int kT, int kMinB>
__global__ void __launch_bounds__(kP ? kT : 1024, kMinB)
linearize_block(const bool* __restrict__ mask,
                const int32_t* __restrict__ elem,
                const int32_t* __restrict__ actor,
                const int32_t* __restrict__ parent,
                int32_t* __restrict__ out, int32_t* scratch, int R, int E,
                int P_any, int steps, long long work) {
  constexpr int kEPT = kP ? kP / kT : 8;  // slots (and sort entries) a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t wred[32][4];  // each warp's key and actor range
  static_assert(sizeof(wred) == kBlockStaticSmem, "wred");
  unsigned char* base = smem;
  if constexpr (kP == 0)
    base = reinterpret_cast<unsigned char*>(scratch) + blockIdx.x * work;
  const int P = kP ? kP : P_any;
  const int S = E + 1;
  int32_t* a0 = reinterpret_cast<int32_t*>(base + 16LL * P);  // key, slot
  int32_t* a1 = a0 + S;   // actor, then each entry's group
  int32_t* pv = a1 + S;   // parent node, then f
  int32_t* nxt = pv + S;  // next (the walk's)
  int32_t* fc = nxt + S;  // first child
  int32_t* ns = fc + S;   // next sibling
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = kP ? kT : static_cast<int>(blockDim.x);
  const int warps = (nt + 31) / 32;
  // each node pass takes kNode nodes a thread, every load before a store
  constexpr int kNode = kEPT + 1;

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * E;
    int any = 0;
    int32_t kmin = kInt32Max, kmax = -kInt32Max - 1;
    int32_t amin = kInt32Max, amax = -kInt32Max - 1;
    for (int s0 = tid; s0 < E; s0 += kEPT * nt) {
      bool m[kEPT];
      int32_t el[kEPT], ac[kEPT], pa[kEPT];
#pragma unroll
      for (int u = 0; u < kEPT; ++u) {
        const int s = s0 + u * nt;
        if (s < E) {
          m[u] = mask[row + s];
          el[u] = elem[row + s];
          ac[u] = actor[row + s];
          pa[u] = parent[row + s];
        }
      }
#pragma unroll
      for (int u = 0; u < kEPT; ++u) {
        const int s = s0 + u * nt;
        if (s < E) {
          a0[s] = m[u] ? el[u] : kInt32Max;
          a1[s] = ac[u];
          pv[s] = parent_node(m[u], pa[u], E);
          if (m[u]) {
            any = 1;
            kmin = min(kmin, el[u]);
            kmax = max(kmax, el[u]);
            amin = min(amin, ac[u]);
            amax = max(amax, ac[u]);
          }
        }
      }
    }
    for (int v = tid; v <= E; v += nt) nxt[v] = fc[v] = ns[v] = -1;
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    amin = __reduce_min_sync(0xffffffffu, amin);
    amax = __reduce_max_sync(0xffffffffu, amax);
    if ((tid & 31) == 0) {
      wred[tid >> 5][0] = kmin;
      wred[tid >> 5][1] = kmax;
      wred[tid >> 5][2] = amin;
      wred[tid >> 5][3] = amax;
    }
    if (!__syncthreads_or(any)) {
      for (int s = tid; s < E; s += nt) out[row + s] = -1;
      continue;  // nothing reads the arrays after the barrier
    }

    // the verdict, and the code of the row's records
    int ok = 1;
    for (int s = tid; s < E; s += nt) {
      const int p = pv[s];
      if (p > 0) {
        ok &= p <= E && pv[p - 1] >= 0 &&
              earlier(a0[p - 1], a1[p - 1], p - 1, a0[s], a1[s], s);
      }
    }
    for (int w = 0; w < warps; ++w) {
      kmin = min(kmin, wred[w][0]);
      kmax = max(kmax, wred[w][1]);
      amin = min(amin, wred[w][2]);
      amax = max(amax, wred[w][3]);
    }
    const bool causal = __syncthreads_and(ok);
    Code c;
    c.ashift = bits_of(static_cast<uint32_t>(E - 1));
    c.kshift = c.ashift + bits_of(static_cast<uint32_t>(amax) -
                                  static_cast<uint32_t>(amin));
    c.gshift = c.kshift + bits_of(static_cast<uint32_t>(kmax) -
                                  static_cast<uint32_t>(kmin));
    c.kmin = kmin;
    c.amin = amin;
    c.smask = (1u << c.ashift) - 1u;
    int32_t* sslot = a0;   // each entry's slot, in sorted order
    int32_t* sgroup = a1;  // and its group
    if (c.gshift + bits_of(static_cast<uint32_t>(E + 2)) <= 31) {
      if constexpr (kP > 0)
        sort_in_registers<Narrow, kP, kT>(reinterpret_cast<Narrow*>(base),
                                          sslot, sgroup, a0, a1, pv, causal,
                                          c, E);
      else
        sort_in_buffer<Narrow>(reinterpret_cast<Narrow*>(base), sslot,
                               sgroup, a0, a1, pv, causal, c, E, P);
    } else {
      if constexpr (kP > 0)
        sort_in_registers<Wide, kP, kT>(reinterpret_cast<Wide*>(base), sslot,
                                        sgroup, a0, a1, pv, causal, c, E);
      else
        sort_in_buffer<Wide>(reinterpret_cast<Wide*>(base), sslot, sgroup,
                             a0, a1, pv, causal, c, E, P);
    }

    // the doubling's buffers of (next, distance) pairs: A over a0 and a1,
    // B over pv and nxt
    int2* da = reinterpret_cast<int2*>(a0);
    int2* db = reinterpret_cast<int2*>(pv);
    any = 0;
    if (causal) {
      // children runs: first child and next siblings, and each node's
      // first pointer toward its nearest ancestor-or-self with a next
      // sibling (f, over pv: the sort has read it)
      int32_t* f = pv;
      for (int i = tid; i < E; i += nt) {
        const int g = sgroup[i];
        const int u = sslot[i] + 1;
        if (g <= E) {
          const bool has_ns = i > 0 && sgroup[i - 1] == g;
          if (has_ns) ns[u] = sslot[i - 1] + 1;
          if (i + 1 == E || sgroup[i + 1] != g) fc[g] = u;
          f[u] = has_ns ? u : g;
        } else {
          f[u] = 0;  // a masked slot
        }
      }
      if (tid == 0) f[0] = 0;
      __syncthreads();
      // pointer jumping in place: a read sees the old or the new pointer,
      // both on the chain and at or before its end, so it converges to
      // the same end; a pass that moves nothing ends it
      int moved;
      do {
        moved = 0;
        for (int v0 = tid; v0 <= E; v0 += kNode * nt) {
          int a[kNode], b[kNode];
#pragma unroll
          for (int u = 0; u < kNode; ++u)
            a[u] = v0 + u * nt <= E ? f[v0 + u * nt] : 0;
#pragma unroll
          for (int u = 0; u < kNode; ++u) b[u] = f[a[u]];
#pragma unroll
          for (int u = 0; u < kNode; ++u) {
            if (a[u] != b[u]) {
              f[v0 + u * nt] = b[u];
              moved = 1;
            }
          }
        }
      } while (__syncthreads_or(moved));
      // the successor, and the first distance
      for (int v = tid; v <= E; v += nt) {
        const int32_t n = fc[v] >= 0 ? fc[v] : (f[v] > 0 ? ns[f[v]] : -1);
        da[v] = make_int2(n, n >= 0);
        any |= n >= 0;
      }
    } else {
      // the walk: one thread, E dependent steps
      if (tid == 0) {
        for (int t = 0; t < E; ++t) {
          const int slot = sslot[t];
          const int p = pv[slot];
          if (p < 0) continue;
          const int node = slot + 1;
          const int32_t succ = nxt[p > E ? E : p];
          nxt[node] = succ;
          if (p <= E) nxt[p] = node;
        }
      }
      __syncthreads();
      for (int v = tid; v <= E; v += nt) {
        da[v] = make_int2(nxt[v], nxt[v] >= 0);
        any |= nxt[v] >= 0;
      }
    }

    // doubling until no pointer is left
    any = __syncthreads_or(any);
    for (int k = 0; k < steps && any; ++k) {
      any = 0;
      for (int v0 = tid; v0 <= E; v0 += kNode * nt) {
        int2 pp[kNode], qq[kNode];
#pragma unroll
        for (int u = 0; u < kNode; ++u)
          pp[u] = v0 + u * nt <= E ? da[v0 + u * nt] : make_int2(-1, 0);
#pragma unroll
        for (int u = 0; u < kNode; ++u)
          qq[u] = pp[u].x >= 0 ? da[pp[u].x] : make_int2(-1, 0);
#pragma unroll
        for (int u = 0; u < kNode; ++u) {
          const int v = v0 + u * nt;
          if (v <= E) {
            db[v] = pp[u].x >= 0 ? make_int2(qq[u].x, pp[u].y + qq[u].y)
                                 : pp[u];
            any |= pp[u].x >= 0 && qq[u].x >= 0;
          }
        }
      }
      any = __syncthreads_or(any);
      int2* t = da;
      da = db;
      db = t;
    }

    const int32_t total = da[0].y;
    for (int s = tid; s < E; s += nt) out[row + s] = total - da[s + 1].y - 1;
    if (r + static_cast<int>(gridDim.x) < R) __syncthreads();  // reuse
  }
}

template <int W>
cudaError_t launch_short(const bool* mask, const int32_t* elem,
                         const int32_t* actor, const int32_t* parent,
                         int32_t* out, int R, int E, cudaStream_t stream) {
  const long long rows_per_block = kShortWarps * (32 / W);
  const int grid = static_cast<int>((R + rows_per_block - 1) /
                                    rows_per_block);
  linearize_short<W><<<grid, kShortWarps * 32, 0, stream>>>(
      mask, elem, actor, parent, out, R, E, ceil_log2(E + 1));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether rows of E slots work in the global scratch: past P = 4,096, or
// where their work area needs more shared memory than a block of the
// current device may opt in to beside the block path's static tables; or
// the negated CUDA error.
int amt_linearize_uses_scratch(int E) {
  if (E <= kShortMax) return 0;
  if (ceil_pow2(E) > 4096) return 1;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return work_bytes(E) > limit - kBlockStaticSmem;
}

// Bytes of one row's work area for rows of E slots: 0 for E <= 32 (a warp
// slice, no work area), else the block path's, a multiple of 16; -1 if it
// does not fit an int.
int amt_linearize_work_bytes(int E) {
  if (E <= kShortMax) return 0;
  const long long b = work_bytes(E);
  return b > 0x7fffffffLL ? -1 : static_cast<int>(b);
}

// Launch on `stream` (a cudaStream_t as a pointer); returns
// cudaGetLastError() after the launch. All arrays are contiguous [R, E];
// R >= 1, 1 <= E. E <= 32: a row a warp slice (scratch and grid unused).
// Else, where amt_linearize_uses_scratch(E) says no, scratch == nullptr:
// a row's work area in shared memory (grid = R); where it says yes,
// scratch holds grid work areas (amt_linearize_work_bytes(E) each) and
// each of the grid's blocks loops over rows.
int amt_linearize(const bool* mask, const int32_t* elem,
                  const int32_t* actor, const int32_t* parent, int32_t* out,
                  int32_t* scratch, int R, int E, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= kShortMax) {
    cudaError_t e;
    switch (ceil_pow2(E)) {
      case 1: e = launch_short<1>(mask, elem, actor, parent, out, R, E, st);
        break;
      case 2: e = launch_short<2>(mask, elem, actor, parent, out, R, E, st);
        break;
      case 4: e = launch_short<4>(mask, elem, actor, parent, out, R, E, st);
        break;
      case 8: e = launch_short<8>(mask, elem, actor, parent, out, R, E, st);
        break;
      case 16:
        e = launch_short<16>(mask, elem, actor, parent, out, R, E, st);
        break;
      default:
        e = launch_short<32>(mask, elem, actor, parent, out, R, E, st);
    }
    return static_cast<int>(e);
  }
  const int P = ceil_pow2(E);
  const long long work = work_bytes(E);
  if (scratch != nullptr) {
    linearize_block<0, 1024, 1><<<grid, 1024, 0, st>>>(
        mask, elem, actor, parent, out, scratch, R, E, P, ceil_log2(E + 1),
        work);
    return static_cast<int>(cudaGetLastError());
  }
  if (P > 4096) return static_cast<int>(cudaErrorInvalidValue);
  // the instance for P, its threads, and for the two whose work area may
  // pass 48 KB the index of their opt-in
  void (*kernel)(const bool*, const int32_t*, const int32_t*, const int32_t*,
                 int32_t*, int32_t*, int, int, int, int, long long);
  int threads = 1024, big = -1;
  if (P <= 64) {
    kernel = linearize_block<64, 32, 16>, threads = 32;
  } else if (P == 128) {
    kernel = linearize_block<128, 64, 16>, threads = 64;
  } else if (P == 256) {
    kernel = linearize_block<256, 64, 16>, threads = 64;
  } else if (P == 512) {
    kernel = linearize_block<512, 128, 8>, threads = 128;
  } else if (P == 1024) {
    kernel = linearize_block<1024, 256, 1>, threads = 256;
  } else if (P == 2048) {
    kernel = linearize_block<2048, 512, 1>, threads = 512, big = 0;
  } else {
    kernel = linearize_block<4096, 1024, 1>, big = 1;
  }
  const size_t bytes = static_cast<size_t>(work);
  if (bytes > 48 * 1024) {
    static int opted[kMaxDevices][2] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (big < 0 || dev >= kMaxDevices ||
        opted[dev][big] < static_cast<int>(bytes)) {
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) {
        cudaGetLastError();  // not left for the next launch's check
        return static_cast<int>(e);
      }
      if (big >= 0 && dev < kMaxDevices)
        opted[dev][big] = static_cast<int>(bytes);
    }
  }
  kernel<<<R, threads, bytes, st>>>(mask, elem, actor, parent, out, nullptr,
                                    R, E, P, ceil_log2(E + 1), work);
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
