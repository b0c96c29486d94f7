// Fused reconcile + state hash over the docs-minor row buffer, for Hopper.
//
// Replaces the TPU kernel automerge_tpu/engine/pallas_kernels.py::
// reconcile_rows_hash (base body _make_reconcile_kernel, XL body
// _make_reconcile_kernel_xl). Both bodies compute one function; the XL body
// exists only because the TPU's on-chip memory could not hold a full join
// axis. Here a lane's join axis is walked in shared-memory tiles (one tile
// for every lane inside the rows engine's envelope), so ONE kernel serves
// both: the wrapper accepts force_xl and the launch is the same.
//
// Input: rows [ROWS, D] int32, documents on the minor axis, every logical
// column a static row range (automerge_tpu_torch/engine/pack.py::row_bases;
// ROWS = 8I + AI + 5LE + A). Output: [D] int32 holding each document's
// uint32 state hash. Per document lane:
//   amask_i     = op_mask_i > 0 & action_i >= A_SET
//   dominated_i = any_j amask_j & amask_i & fid_j == fid_i & chg_j != chg_i
//                       & clock_op[actor_i][j] >= seq_i
//   candidate_i = amask_i & !dominated_i & action_i != A_DEL
//   visible_e   = valid_e & any_j candidate_j & fid_j == ins_fid_e
//   rank_e      = visible_e ? #{f visible, same list, ins_pos_f < ins_pos_e}
//                           : -1
//   op -> (is_list, objhash, rank) joined on fid == ins_fid over valid elems
//   hash        = sum over candidates of mix4(key1, key2, actor_hash, vh),
//                 wrapping in uint32.
//
// What bounds it on an H100: the bytes the function needs, at 3.35 TB/s:
// op_mask of every slot, action of a slot with op_mask > 0, fid and change
// of live ops, actor and seq of live non-deletes and the clock cells their
// domination reads, the value hash of candidates and the field hash of those
// on no list, ins_mask of every element slot, ins_fid where it is set, the
// other element columns of visible elements, the actor hashes used, and the
// hashes written.
// The pairwise compares (live ops squared, plus the element joins) are far
// below the card's integer rate for the fleets the rows engine serves.
//
// Design: a team of threads per lane, never one thread, so a heavy lane's
// pair loops split across the team and no pass waits on a serial walk: a
// team of 64 threads (two warps, their own named barrier) per lane, four
// lanes a block of 256 (one lane a block of 64 where a lane's shared memory
// does not fit a quarter of the block). Measured on an H100 against teams
// of 32, 128 and 256 (one warp, half a block, a whole block per lane), it
// was the fastest on both rows workloads (PERF.md): most map-storm lanes
// hold a few ops, so a lane's cost is its chain of dependent loads and more
// lanes in flight hide it, while a text-fleet lane's joins still split
// across 64 threads.
// Per lane, in shared memory (lane_team.cuh's pair passes):
//   0. scan: op_mask of every slot, action where op_mask > 0 -> a flag byte
//      per op slot (live, may-be-candidate); ins_mask of every element slot,
//      ins_fid where ins_mask > 0 -> a state int per element slot; each
//      thread issues kScan slots' loads before it waits on any;
//   1. domination: live ops staged as (fid, chg, 0, clock row) entries and
//      indexed by fid; each non-delete live op walks its field's entries ->
//      candidate bit;
//   2. visibility: candidates' fids staged and indexed; each valid element
//      looks its field up;
//   3. ranks: visible elements' (pos, list) staged; each visible element
//      counts its predecessors -> the element's state int is its rank;
//   4. the op -> element map and the hash: visible elements' (fid, objhash,
//      rank) staged and indexed by fid; each candidate takes its field's
//      maxima, mixes its term, and a team reduction adds the terms (uint32
//      wrapping: any order, same bits).
// Each pass reads from device memory only the rows of the slots it needs.
// No scratch lives in device memory. The shared memory is sized from the
// dims: a tile large enough for the whole lane (every slot live) when the
// card allows it, smaller tiles walked in turn when it does not.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_team.cuh"

namespace {

using amt::PassMem;
using amt::Team;

constexpr uint8_t kLive = 1;   // amask
constexpr uint8_t kNeed = 2;   // amask & action != A_DEL: may be a candidate
constexpr uint8_t kCand = 4;   // candidate
// element states: >= 0 visible (its rank once pass 3 ran), kValid valid
// but not visible, kInvalid not a valid element
constexpr int kValid = -1;
constexpr int kInvalid = -2;

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

// One lane's column of the row buffer and its per-slot state in shared
// memory. at(row) reads row `row` of this lane.
struct Lane {
  const int32_t* x;  // the buffer, offset to this lane
  size_t D;
  int I, A, LE;
  size_t r_co, r_im;
  uint8_t* flag;     // [I]
  int* el;           // [LE]
  __device__ int32_t at(size_t row) const { return x[row * D]; }
  __device__ int32_t fid(int s) const { return at(2 * (size_t)I + s); }
  __device__ int32_t actor(int s) const { return at(3 * (size_t)I + s); }
  __device__ int32_t seq(int s) const { return at(4 * (size_t)I + s); }
  __device__ int32_t chg(int s) const { return at(5 * (size_t)I + s); }
  __device__ int32_t fh(int s) const { return at(6 * (size_t)I + s); }
  __device__ int32_t vh(int s) const { return at(7 * (size_t)I + s); }
  __device__ int32_t clock(int s, int a) const {
    return at(r_co + (size_t)a * I + s);
  }
  __device__ int32_t im(int e) const { return at(r_im + e); }
  __device__ int32_t ifd(int e) const { return at(r_im + LE + e); }
  __device__ int32_t ip(int e) const { return at(r_im + 2 * (size_t)LE + e); }
  __device__ int32_t io(int e) const { return at(r_im + 3 * (size_t)LE + e); }
  __device__ int32_t il(int e) const { return at(r_im + 4 * (size_t)LE + e); }
  __device__ int32_t ah(int a) const { return at(r_im + 5 * (size_t)LE + a); }
};

// Pass 1's source: live ops dominate, non-delete live ops may be dominated.
struct DomSrc : Lane {
  static constexpr bool kOutOfRangeReadsZero = false;
  int n;
  __device__ bool take_i(int s) const { return flag[s] & kNeed; }
  __device__ bool take_j(int s) const { return flag[s] & kLive; }
  __device__ void finish(int s, bool dominated) const {
    if (!dominated) flag[s] |= kCand;
  }
};

// Pass 2: a valid element is visible when a candidate writes its field.
struct VisPass {
  static constexpr bool kKeyed = true;
  Lane L;
  struct IState {
    int32_t f;
    bool vis;
  };
  __device__ int n_i() const { return L.LE; }
  __device__ int n_j() const { return L.I; }
  __device__ int entry_ints() const { return 1; }
  __device__ bool take_i(int e) const { return L.el[e] >= kValid; }
  __device__ bool take_j(int s) const { return L.flag[s] & kCand; }
  __device__ void stage_j(int s, int* dst) const { dst[0] = L.fid(s); }
  __device__ bool load_i(int e, IState& st) const {
    st.f = L.ifd(e);
    st.vis = false;
    return false;
  }
  __device__ int32_t key(const IState& st) const { return st.f; }
  __device__ bool visit(IState& st, const int*) const {
    st.vis = true;
    return true;
  }
  __device__ void finish(int e, const IState& st) const {
    L.el[e] = st.vis ? 0 : kValid;
  }
};

// Pass 3: a visible element's rank among its list's visible elements.
struct RankPass {
  static constexpr bool kKeyed = false;
  Lane L;
  struct IState {
    int32_t pos, lst, cnt;
  };
  __device__ int n_i() const { return L.LE; }
  __device__ int n_j() const { return L.LE; }
  __device__ int entry_ints() const { return 2; }
  __device__ bool take_i(int e) const { return L.el[e] >= 0; }
  __device__ bool take_j(int e) const { return L.el[e] >= 0; }
  __device__ void stage_j(int e, int* dst) const {
    dst[0] = L.ip(e);
    dst[1] = L.il(e);
  }
  __device__ bool load_i(int e, IState& st) const {
    st.pos = L.ip(e);
    st.lst = L.il(e);
    st.cnt = 0;
    return false;
  }
  __device__ bool visit(IState& st, const int* ent) const {
    st.cnt += (ent[1] == st.lst) & (ent[0] < st.pos);
    return false;
  }
  __device__ void finish(int e, const IState& st) const { L.el[e] = st.cnt; }
};

// Pass 4: each candidate's element join, then its hash term. A valid
// element on a candidate's field is visible (pass 2), so the join stages
// the visible elements only, and a field with none is not a list: only
// then is the candidate's field hash read.
struct HashPass {
  static constexpr bool kKeyed = true;
  Lane L;
  uint32_t acc;
  struct IState {
    int32_t fid, oh, rk, vh, ah;
    bool is_list;
  };
  __device__ int n_i() const { return L.I; }
  __device__ int n_j() const { return L.LE; }
  __device__ int entry_ints() const { return 3; }
  __device__ bool take_i(int s) const { return L.flag[s] & kCand; }
  __device__ bool take_j(int e) const { return L.el[e] >= 0; }
  __device__ void stage_j(int e, int* dst) const {
    dst[0] = L.ifd(e);
    dst[1] = L.io(e);
    dst[2] = L.el[e];  // the rank
  }
  __device__ bool load_i(int s, IState& st) const {
    st.fid = L.fid(s);
    st.vh = L.vh(s);
    const int32_t act = L.actor(s);
    st.ah = (act >= 0 && act < L.A) ? L.ah(act) : 0;
    st.oh = -1;
    st.rk = -1;
    st.is_list = false;
    return false;
  }
  __device__ int32_t key(const IState& st) const { return st.fid; }
  __device__ bool visit(IState& st, const int* ent) const {
    st.is_list = true;
    st.oh = max(st.oh, ent[1]);
    st.rk = max(st.rk, ent[2]);
    return false;
  }
  __device__ void finish(int s, const IState& st) {
    const int32_t key1 = st.is_list ? st.oh : -7;
    const int32_t key2 = st.is_list ? st.rk : L.fh(s);
    acc += mix4(static_cast<uint32_t>(key1), static_cast<uint32_t>(key2),
                static_cast<uint32_t>(st.ah), static_cast<uint32_t>(st.vh));
  }
};

// Threads per lane, and lanes per block where a lane's shared memory fits a
// quarter of the block (one lane a block where it does not).
constexpr int kTeam = 64;
constexpr int kLanes = 4;
// Slots a thread scans at once, so their loads are in flight together.
constexpr int kScan = 8;

// `lanes` teams a block. One team's shared memory: the pair passes'
// scratch, i window, tile and index, then the element states and the op
// flags.
__global__ void __launch_bounds__(kTeam * kLanes)
reconcile_rows_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                      int n_lanes, int I, int A, int LE, int a_set, int a_del,
                      int lanes, int tile_ints, int key_cap, int slot_shift,
                      int team_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = static_cast<int>(threadIdx.x) / kTeam;
  const int d = blockIdx.x * lanes + team;
  if (d >= n_lanes) return;  // a whole team leaves, never part of one
  int* misc;
  PassMem m;
  unsigned char* state = amt::lay_out<kTeam>(
      smem + static_cast<size_t>(team) * team_bytes, tile_ints, key_cap,
      slot_shift, &misc, &m);
  Team<kTeam> t{static_cast<int>(threadIdx.x) % kTeam, team, misc};

  Lane L;
  L.x = x + d;
  L.D = static_cast<size_t>(n_lanes);
  L.I = I;
  L.A = A;
  L.LE = LE;
  L.r_co = 8 * static_cast<size_t>(I);
  L.r_im = L.r_co + static_cast<size_t>(A) * I;
  L.el = reinterpret_cast<int*>(state);
  L.flag = reinterpret_cast<uint8_t*>(L.el + LE);

  // 0: the scan, kScan slots a thread at a time
  for (int base = 0; base < I; base += kScan * kTeam) {
    int32_t om[kScan], ac[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int s = base + u * kTeam + t.rank;
      om[u] = s < I ? L.at(s) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int s = base + u * kTeam + t.rank;
      ac[u] = om[u] > 0 ? L.at(static_cast<size_t>(I) + s) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int s = base + u * kTeam + t.rank;
      if (s < I) {
        L.flag[s] = (om[u] > 0 && ac[u] >= a_set)
                        ? (kLive | (ac[u] != a_del ? kNeed : 0))
                        : 0;
      }
    }
  }
  for (int base = 0; base < LE; base += kScan * kTeam) {
    int32_t im[kScan], f[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int e = base + u * kTeam + t.rank;
      im[u] = e < LE ? L.im(e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int e = base + u * kTeam + t.rank;
      f[u] = im[u] > 0 ? L.ifd(e) : -1;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int e = base + u * kTeam + t.rank;
      if (e < LE) L.el[e] = f[u] >= 0 ? kValid : kInvalid;
    }
  }
  t.sync();

  amt::DomPass<DomSrc> dom;
  static_cast<Lane&>(dom.src) = L;
  dom.src.n = I;
  amt::pair_pass(t, dom, m);
  if (LE > 0) {
    VisPass vis{L};
    amt::pair_pass(t, vis, m);
    RankPass rank{L};
    amt::pair_pass(t, rank, m);
  }
  HashPass hp{L, 0u};
  amt::pair_pass(t, hp, m);
  const uint32_t h = t.sum(hp.acc);
  if (t.rank == 0) out[d] = static_cast<int32_t>(h);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as a pointer); returns cudaGetLastError()
// after the launch, 0 when the launch was accepted, cudaErrorInvalidValue
// when one lane's state does not fit a whole block of the card's shared
// memory (I bytes of op flags and 4 LE bytes of element states, beside the
// team's scratch and a tile of one entry of 3 + A ints: on an H100's 227 KB,
// LE up to about 57K at I = 1,024, far beyond any dims the rows engine
// admits).
int amt_reconcile_rows_hash(const int32_t* rows, int32_t* out, int n_lanes,
                            int I, int A, int LE, int a_set, int a_del,
                            void* stream) {
  // a tile for every slot live: the largest entry of any pass, times I or LE
  const long long want_ops = static_cast<long long>(I) * (3 + A);
  const long long want_el = 3LL * LE;
  static int opted[amt::kMaxDevices] = {};
  amt::Launch l;
  const cudaError_t e = amt::plan_launch<kTeam>(
      reinterpret_cast<const void*>(reconcile_rows_kernel), opted,
      want_ops > want_el ? want_ops : want_el, I > LE ? I : LE,
      4LL * LE + I, 3 + A, kLanes, &l);
  if (e != cudaSuccess) return static_cast<int>(e);
  reconcile_rows_kernel<<<(n_lanes + l.lanes - 1) / l.lanes, kTeam * l.lanes,
                          l.block_bytes, static_cast<cudaStream_t>(stream)>>>(
      rows, out, n_lanes, I, A, LE, a_set, a_del, l.lanes, l.plan.tile,
      l.plan.key_cap, l.plan.slot_shift, static_cast<int>(l.plan.bytes));
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
