// Fused reconcile + state hash over the docs-minor row buffer, for Hopper.
//
// Replaces the TPU kernel automerge_tpu/engine/pallas_kernels.py::
// reconcile_rows_hash (base body _make_reconcile_kernel, XL body
// _make_reconcile_kernel_xl). Both bodies compute one function; the XL body
// exists only because the TPU's on-chip memory could not hold a full join
// axis. Nothing here is sized by on-chip memory (the scratches live in
// device memory), so ONE kernel serves both: the wrapper accepts force_xl
// and the result is the same.
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
// What bounds it on an H100: one read of the buffer, ROWS * D * 4 bytes, at
// 3.35 TB/s; and the pairwise compares, I*I*D (domination) + LE*LE*D
// (ranks) + I*LE*D (visibility and the op -> element map), counted for the
// ops and elements a lane really holds. For the fleets the rows engine
// serves (most lanes hold a few ops, a few lanes hold hundreds), the bytes
// bound.
//
// Design, right and simple first: one thread per document lane. Row r of
// the buffer is contiguous across lanes, so a warp reading row r for 32
// neighbouring documents issues one coalesced load, and every join below is
// a loop over rows. Domination reads clock_op[actor_i * I + j] directly (a
// row gather that replaces the TPU's loop over A of (actor == a) selects).
// A thread whose op is masked out, or not a candidate, skips its inner loop.
// Three docs-minor int32 scratches, allocated by the wrapper, carry results
// between passes: st [I, D] (bit 0 amask, bit 1 candidate), vis [LE, D] and
// rank [LE, D]. The op -> element map is computed only for candidates, in
// the hash pass, so it needs no scratch. Later work: more blocks than lanes
// at small fleets, shared-memory tiles of the op bands, and the O(I*A)
// segment-max form of domination (automerge_tpu/engine/kernels.py:58-70).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void reconcile_rows_kernel(const int32_t* __restrict__ x,
                                      int32_t* __restrict__ out,
                                      int32_t* __restrict__ st,
                                      int32_t* __restrict__ vis,
                                      int32_t* __restrict__ rank,
                                      int n_lanes, int I, int A, int LE,
                                      int a_set, int a_del) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n_lanes) return;
  const size_t D = static_cast<size_t>(n_lanes);
  // band base pointers for this lane: element k of a band is base[k * D]
  const int32_t* xd = x + d;
  const int32_t* om = xd;
  const int32_t* ac = xd + 1 * I * D;
  const int32_t* fid = xd + 2 * I * D;
  const int32_t* act = xd + 3 * I * D;
  const int32_t* seq = xd + 4 * I * D;
  const int32_t* chg = xd + 5 * I * D;
  const int32_t* fh = xd + 6 * I * D;
  const int32_t* vh = xd + 7 * I * D;
  const size_t r_co = 8 * static_cast<size_t>(I);
  const int32_t* co = xd + r_co * D;
  const size_t r_im = r_co + static_cast<size_t>(A) * I;
  const int32_t* im = xd + r_im * D;
  const int32_t* ifd = xd + (r_im + LE) * D;
  const int32_t* ip = xd + (r_im + 2 * static_cast<size_t>(LE)) * D;
  const int32_t* io = xd + (r_im + 3 * static_cast<size_t>(LE)) * D;
  const int32_t* il = xd + (r_im + 4 * static_cast<size_t>(LE)) * D;
  const int32_t* ah = xd + (r_im + 5 * static_cast<size_t>(LE)) * D;
  int32_t* std_ = st + d;
  int32_t* visd = vis + d;
  int32_t* rankd = rank + d;

  // pass 0: amask
  for (int i = 0; i < I; ++i) {
    std_[i * D] = (om[i * D] > 0 && ac[i * D] >= a_set) ? 1 : 0;
  }

  // pass 1: domination -> candidate bit
  for (int i = 0; i < I; ++i) {
    if (!(std_[i * D] & 1)) continue;
    const int32_t ac_i = ac[i * D];
    if (ac_i == a_del) continue;  // never a candidate, dominated or not
    const int32_t fid_i = fid[i * D];
    const int32_t chg_i = chg[i * D];
    const int32_t seq_i = seq[i * D];
    const int32_t act_i = act[i * D];
    bool dominated = false;
    if (act_i >= 0 && act_i < A) {
      const int32_t* cj = co + static_cast<size_t>(act_i) * I * D;
      for (int j = 0; j < I; ++j) {
        if ((std_[j * D] & 1) && fid[j * D] == fid_i && chg[j * D] != chg_i &&
            cj[j * D] >= seq_i) {
          dominated = true;
          break;
        }
      }
    }
    if (!dominated) std_[i * D] = 3;
  }

  if (LE > 0) {
    // pass 2: element visibility
    for (int e = 0; e < LE; ++e) {
      const int32_t f = ifd[e * D];
      int v = 0;
      if (im[e * D] > 0 && f >= 0) {
        for (int j = 0; j < I; ++j) {
          if ((std_[j * D] & 2) && fid[j * D] == f) {
            v = 1;
            break;
          }
        }
      }
      visd[e * D] = v;
    }
    // pass 3: visible rank among the same list's visible elements
    for (int e = 0; e < LE; ++e) {
      if (!visd[e * D]) {
        rankd[e * D] = -1;
        continue;
      }
      const int32_t pos_e = ip[e * D];
      const int32_t lst_e = il[e * D];
      int cnt = 0;
      for (int f = 0; f < LE; ++f) {
        cnt += (visd[f * D] && il[f * D] == lst_e && ip[f * D] < pos_e);
      }
      rankd[e * D] = cnt;
    }
  }

  // pass 4: hash over candidates, op -> element map on the fly
  uint32_t acc = 0;
  for (int i = 0; i < I; ++i) {
    if (!(std_[i * D] & 2)) continue;
    const int32_t fid_i = fid[i * D];
    int32_t key1 = -7;
    int32_t key2 = fh[i * D];
    if (LE > 0) {
      bool is_list = false;
      int32_t oh = -1, rk = -1;
      for (int e = 0; e < LE; ++e) {
        const int32_t f = ifd[e * D];
        if (im[e * D] > 0 && f >= 0 && f == fid_i) {
          is_list = true;
          oh = max(oh, io[e * D]);
          rk = max(rk, rankd[e * D]);
        }
      }
      if (is_list) {
        key1 = oh;
        key2 = rk;
      }
    }
    const int32_t act_i = act[i * D];
    const int32_t ah_i =
        (act_i >= 0 && act_i < A) ? ah[static_cast<size_t>(act_i) * D] : 0;
    acc += mix4(static_cast<uint32_t>(key1), static_cast<uint32_t>(key2),
                static_cast<uint32_t>(ah_i),
                static_cast<uint32_t>(vh[i * D]));
  }
  out[d] = static_cast<int32_t>(acc);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as a pointer); returns cudaGetLastError()
// after the launch, 0 when the launch was accepted. vis and rank may be null
// when LE == 0.
int amt_reconcile_rows_hash(const int32_t* rows, int32_t* out, int32_t* st,
                            int32_t* vis, int32_t* rank, int n_lanes, int I,
                            int A, int LE, int a_set, int a_del,
                            void* stream) {
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  reconcile_rows_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rows, out, st, vis, rank, n_lanes, I, A, LE, a_set, a_del);
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
