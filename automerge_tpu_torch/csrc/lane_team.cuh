// Team-level building blocks shared by the reconcile kernel
// (reconcile_rows.cu) and the domination kernel (dominated.cu), for Hopper.
//
// A team is TEAM threads (a warp, or several warps with a named barrier of
// their own) that work together on one document lane; a block holds one or
// more teams. A lane's joins are "for every slot i with P, reduce over
// every slot j with Q". A team runs such a join as a pair pass (pair_pass
// below):
//   - the slots i with P are compacted, by a warp ballot and a prefix
//     count, into windows of kPerThread * TEAM, so each thread holds up to
//     kPerThread of them in registers whatever the slot layout;
//   - the slots j with Q are compacted the same way into a tile in shared
//     memory, each entry holding the few values the join reads of j; a lane
//     whose j set fits the tile (every lane inside the rows engine's
//     envelope does) is staged once, and a larger one is walked tile by
//     tile, the way dominated.cu first walked its j axis;
//   - a join on equal keys (domination and visibility on the field id, the
//     op -> element map on the element's field) builds a hash index of the
//     tile by the entry's key, so each i walks only the entries of its own
//     key; another join walks every staged entry (the same entry for the
//     whole warp: a shared-memory broadcast). Either walk stops once the
//     thread's results are decided.
// Every loop bound is the same for the whole team, so the barriers inside
// are uniform.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace amt {

// Ints of the per-team scratch a Team needs: one count per warp (at most
// 32) and the cursor stage_tile hands over.
constexpr int kMiscInts = 40;
constexpr int kNextSlot = 32;
// Results one thread holds per window of i.
constexpr int kPerThread = 4;

template <int TEAM>
struct Team {
  static_assert(TEAM % 32 == 0 && TEAM <= 1024, "TEAM is whole warps");
  int rank;    // thread index inside the team
  int bar;     // this team's named barrier (unused by a one-warp team)
  int* misc;   // kMiscInts ints of this team's shared memory

  __device__ void sync() const {
    if (TEAM == 32) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(TEAM) : "memory");
    }
  }

  // Position of this thread's `pred` among the team's true predicates, in
  // rank order; *total gets their count.
  __device__ int compact(bool pred, int* total) const {
    const unsigned b = __ballot_sync(0xffffffffu, pred);
    const int lane = rank & 31;
    const int below = __popc(b & ((1u << lane) - 1u));
    if (TEAM == 32) {
      *total = __popc(b);
      return below;
    }
    const int w = rank >> 5;
    if (lane == 0) misc[w] = __popc(b);
    sync();
    int off = 0, tot = 0;
#pragma unroll
    for (int k = 0; k < TEAM / 32; ++k) {
      const int c = misc[k];
      off += k < w ? c : 0;
      tot += c;
    }
    sync();
    *total = tot;
    return off + below;
  }

  // The team's uint32 sum of v (wrapping; any order gives the same bits).
  __device__ uint32_t sum(uint32_t v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (TEAM == 32) return v;
    if ((rank & 31) == 0) misc[rank >> 5] = static_cast<int>(v);
    sync();
    uint32_t t = 0;
#pragma unroll
    for (int k = 0; k < TEAM / 32; ++k) t += static_cast<uint32_t>(misc[k]);
    sync();
    return t;
  }
};

// Shared memory of one team's pair passes.
struct PassMem {
  int* ilist;     // kPerThread * TEAM slot indices
  int* tile;      // tile_ints ints of staged j entries
  int tile_ints;
  // The hash index of a keyed pass's tile: key_cap entries at most, in
  // 2 * key_cap slots (a power of two) of (representative entry, chain
  // head), chains through next.
  int* rep;
  int* head;
  int* next;
  int key_cap;
  int slot_shift;  // 32 - log2(2 * key_cap)
};

// Ints of the index for key_cap entries, padded to 16 bytes.
__host__ __device__ constexpr long long index_ints(long long key_cap) {
  return (5 * key_cap + 3) / 4 * 4;
}

__device__ __forceinline__ int key_slot(int32_t key, int shift) {
  return static_cast<int>((static_cast<uint32_t>(key) * 0x9E3779B1u) >>
                          shift);
}

// Compacts the j slots from `cur` on that pass the join's Q into the tile,
// until it holds cap entries. Returns the count; *next gets the first slot
// not staged (n_j when the rest fitted).
template <int TEAM, class P>
__device__ int stage_tile(const Team<TEAM>& t, const P& p, int cur,
                          const PassMem& m, int cap, int* next) {
  const int n = p.n_j();
  const int e = p.entry_ints();
  int count = 0, nxt = n;
  for (int base = cur; base < n; base += TEAM) {
    const int s = base + t.rank;
    const bool pred = s < n && p.take_j(s);
    int total;
    const int pos = count + t.compact(pred, &total);
    if (pred) {
      if (pos < cap) {
        p.stage_j(s, m.tile + pos * e);
      } else if (pos == cap) {
        t.misc[kNextSlot] = s;
      }
    }
    count += total;
    if (count >= cap) {
      t.sync();
      nxt = count > cap ? t.misc[kNextSlot] : min(base + TEAM, n);
      count = cap;
      break;
    }
  }
  t.sync();
  *next = nxt;
  return count;
}

// Indexes the nj staged entries by their first int (linear probing; a slot
// keeps the first entry that claimed it as its key's representative).
template <int TEAM>
__device__ void build_index(const Team<TEAM>& t, const PassMem& m, int nj,
                            int e) {
  const int slots = 2 * m.key_cap;
  for (int h = t.rank; h < slots; h += TEAM) {
    m.rep[h] = -1;
    m.head[h] = -1;
  }
  t.sync();
  for (int j = t.rank; j < nj; j += TEAM) {
    const int32_t key = m.tile[j * e];
    for (int h = key_slot(key, m.slot_shift);; h = (h + 1) & (slots - 1)) {
      int r = m.rep[h];
      if (r < 0) {
        r = atomicCAS(&m.rep[h], -1, j);
        if (r < 0) r = j;
      }
      if (m.tile[r * e] == key) {
        m.next[j] = atomicExch(&m.head[h], j);
        break;
      }
    }
  }
  t.sync();
}

// The first staged entry of `key`'s chain, -1 when the tile has none.
__device__ __forceinline__ int index_find(const PassMem& m, int32_t key,
                                          int e) {
  const int slots = 2 * m.key_cap;
  for (int h = key_slot(key, m.slot_shift);; h = (h + 1) & (slots - 1)) {
    const int r = m.rep[h];
    if (r < 0) return -1;
    if (m.tile[r * e] == key) return m.head[h];
  }
}

// Runs the join P: for every i slot with take_i, load_i into registers
// (true when its result is decided without a walk), visit the staged j
// entries until visit returns true, then finish. P supplies n_i(), n_j(),
// entry_ints(), take_i(s), take_j(s), stage_j(s, dst), load_i(s, st),
// visit(st, entry), finish(s, st), a type IState and kKeyed; a keyed P
// also key(st), and visits only the entries whose first int is that key.
template <int TEAM, class P>
__device__ void pair_pass(const Team<TEAM>& t, P& p, const PassMem& m) {
  constexpr int W = kPerThread * TEAM;
  const int e_ints = p.entry_ints();
  int cap = m.tile_ints / e_ints;
  if (P::kKeyed && cap > m.key_cap) cap = m.key_cap;
  const int n_i = p.n_i(), n_j = p.n_j();
  int tile_at = -1, tile_next = 0, nj = 0;
  for (int w0 = 0; w0 < n_i; w0 += W) {
    int ni = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (w0 + k * TEAM >= n_i) break;
      const int s = w0 + k * TEAM + t.rank;
      const bool pred = s < n_i && p.take_i(s);
      int total;
      const int pos = ni + t.compact(pred, &total);
      if (pred) m.ilist[pos] = s;
      ni += total;
    }
    if (ni == 0) continue;
    t.sync();
    typename P::IState st[kPerThread];
    int slot[kPerThread];
    bool done[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int q = k * TEAM + t.rank;
      slot[k] = q < ni ? m.ilist[q] : -1;
      done[k] = slot[k] < 0 || p.load_i(slot[k], st[k]);
    }
    for (int cur = 0;;) {
      if (cur != tile_at) {
        nj = stage_tile(t, p, cur, m, cap, &tile_next);
        if constexpr (P::kKeyed) build_index(t, m, nj, e_ints);
        tile_at = cur;
      }
      if constexpr (P::kKeyed) {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (done[k]) continue;
          for (int j = index_find(m, p.key(st[k]), e_ints); j >= 0;
               j = m.next[j]) {
            if (p.visit(st[k], m.tile + j * e_ints)) {
              done[k] = true;
              break;
            }
          }
        }
      } else {
        for (int j = 0; j < nj; ++j) {
          const int* ent = m.tile + j * e_ints;
          bool open = false;
#pragma unroll
          for (int k = 0; k < kPerThread; ++k) {
            if (!done[k]) {
              done[k] = p.visit(st[k], ent);
              open = true;
            }
          }
          if (!open) break;
        }
      }
      cur = tile_next;
      if (cur >= n_j) break;
      t.sync();  // the tile is restaged next
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (slot[k] >= 0) p.finish(slot[k], st[k]);
    }
    t.sync();  // ilist and the finished state, before the next window
  }
}

// Causal domination, the join both kernels share:
//   dominated_i = exists j: take_j(j) & fid_j == fid_i & chg_j != chg_i
//                           & clock_j[actor_i] >= seq_i
// for every i with take_i, keyed on the field id. A tile entry is (fid,
// chg, 0, clock row of A ints), so clock_j[actor_i] is a shared-memory read
// and the zero column serves an actor outside [0, A) where
// Src::kOutOfRangeReadsZero (the domination kernel's contract: such an
// actor reads a clock of 0); where it is false (the reconcile's contract:
// such an op is never dominated), load_i decides the op at once. Src
// supplies n, A, take_i, take_j, fid, chg, seq, actor, clock(s, a) and
// finish(s, dominated).
template <class Src>
struct DomPass {
  static constexpr bool kKeyed = true;
  Src src;
  struct IState {
    int32_t fid, chg, seq;
    int col;
    bool dom;
  };
  __device__ int n_i() const { return src.n; }
  __device__ int n_j() const { return src.n; }
  __device__ int entry_ints() const { return 3 + src.A; }
  __device__ bool take_i(int s) const { return src.take_i(s); }
  __device__ bool take_j(int s) const { return src.take_j(s); }
  __device__ void stage_j(int s, int* dst) const {
    dst[0] = src.fid(s);
    dst[1] = src.chg(s);
    dst[2] = 0;
    for (int a = 0; a < src.A; ++a) dst[3 + a] = src.clock(s, a);
  }
  __device__ bool load_i(int s, IState& st) const {
    st.dom = false;
    const int32_t act = src.actor(s);
    const bool in_range = act >= 0 && act < src.A;
    if (!in_range && !Src::kOutOfRangeReadsZero) return true;
    st.fid = src.fid(s);
    st.chg = src.chg(s);
    st.seq = src.seq(s);
    st.col = in_range ? 3 + act : 2;
    return false;
  }
  __device__ int32_t key(const IState& st) const { return st.fid; }
  __device__ bool visit(IState& st, const int* e) const {
    if (e[1] != st.chg && e[st.col] >= st.seq) {
      st.dom = true;
      return true;
    }
    return false;
  }
  __device__ void finish(int s, const IState& st) const {
    src.finish(s, st.dom);
  }
};

inline long long align16(long long b) { return (b + 15) / 16 * 16; }

// One team's shared-memory plan: the scratch and i window, a tile of
// `want` ints (enough for the whole lane) and the index of a keyed pass
// for up to `keyed` entries, then `state_bytes` of per-slot state; the
// index is halved until the tile holds one entry of `min_entry` ints in
// what the device's shared memory per block leaves each of `lanes` teams.
// tile is 0 when nothing fits (plan_launch below then takes one team a
// block).
struct TeamPlan {
  int tile = 0;
  int key_cap = 0;
  int slot_shift = 0;
  long long bytes = 0;  // one team's whole share, a multiple of 16
};

template <int TEAM>
TeamPlan plan_team(long long want, long long keyed, long long state_bytes,
                   int min_entry, int lanes, long long max_block_bytes) {
  TeamPlan pl;
  const long long fixed =
      4LL * (kMiscInts + kPerThread * TEAM) + align16(state_bytes);
  const long long room = (max_block_bytes / lanes - fixed) / 16 * 4;  // ints
  if (want < min_entry) want = min_entry;
  want = (want + 3) / 4 * 4;
  int kc = 1, log2 = 0;
  while (kc < keyed) {
    kc <<= 1;
    ++log2;
  }
  for (; kc >= 1; kc >>= 1, --log2) {
    const long long idx = index_ints(kc);
    const long long tile = want < room - idx ? want : room - idx;
    if (tile >= min_entry) {
      pl.tile = static_cast<int>(tile);
      pl.key_cap = kc;
      pl.slot_shift = 32 - (log2 + 1);  // 2 * kc slots
      pl.bytes = fixed + 4 * (tile + idx);
      return pl;
    }
  }
  return pl;
}

// A launch: its teams' plan, the teams a block holds and the dynamic shared
// memory of a block.
struct Launch {
  TeamPlan plan;
  int lanes = 0;
  long long block_bytes = 0;
};

constexpr int kMaxDevices = 64;

// Plans a launch of `kernel`, `lanes` teams a block when one team's plan
// fits a `lanes`-th of the device's opt-in shared memory per block, one team
// a block otherwise, and opts `kernel` in above 48 KB once per device
// (`opted`: the kernel's own record, kMaxDevices ints, zeroed). Returns
// cudaErrorInvalidValue when not even one team fits the whole block.
template <int TEAM>
cudaError_t plan_launch(const void* kernel, int* opted, long long want,
                        long long keyed, long long state_bytes, int min_entry,
                        int lanes, Launch* out) {
  int dev = 0, max_block = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_block,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  out->plan = plan_team<TEAM>(want, keyed, state_bytes, min_entry, lanes,
                              max_block);
  if (out->plan.tile == 0 && lanes > 1) {
    lanes = 1;
    out->plan = plan_team<TEAM>(want, keyed, state_bytes, min_entry, 1,
                                max_block);
  }
  if (out->plan.tile == 0) return cudaErrorInvalidValue;
  out->lanes = lanes;
  out->block_bytes = out->plan.bytes * lanes;
  const bool known = dev < kMaxDevices;
  if (out->block_bytes > 48 * 1024 && !(known && opted[dev] >= max_block)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_block);
    if (e != cudaSuccess) return e;
    if (known) opted[dev] = max_block;
  }
  return cudaSuccess;
}

// Lays a team's plan out from `base`: misc, ilist, tile, index; returns
// the start of the per-slot state after them.
template <int TEAM>
__device__ unsigned char* lay_out(unsigned char* base, int tile_ints,
                                  int key_cap, int slot_shift, int** misc,
                                  PassMem* m) {
  *misc = reinterpret_cast<int*>(base);
  m->ilist = *misc + kMiscInts;
  m->tile = m->ilist + kPerThread * TEAM;
  m->tile_ints = tile_ints;
  m->rep = m->tile + tile_ints;
  m->head = m->rep + 2 * key_cap;
  m->next = m->head + 2 * key_cap;
  m->key_cap = key_cap;
  m->slot_shift = slot_shift;
  return reinterpret_cast<unsigned char*>(m->rep + index_ints(key_cap));
}

}  // namespace amt
