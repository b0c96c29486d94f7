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
// holds few ops, so bytes bound it at the main path's shapes. This kernel
// stages fid and change of every op, masked ones too.
//
// Design, right and simple first: one thread block per document, one
// thread per op i (the block strides over i when N exceeds it). The j axis
// is walked in tiles of (fid, change, amask) staged in shared memory, so a
// warp reads each j once from shared memory; clock_op[j, actor_i] is read
// from device memory only for a j that passes the field, change and mask
// tests. A thread stops testing at its first hit; the tile loop has no cap
// on N. Later work: several small documents a block, and the clock rows
// of a tile in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;

// blockDim.x is a multiple of 32, at most 1024. Every thread runs the same
// number of iterations of both loops, so the barriers are uniform.
__global__ void dominated_kernel(const int32_t* __restrict__ clock_op,
                                 const int32_t* __restrict__ actor,
                                 const int32_t* __restrict__ fid,
                                 const int32_t* __restrict__ seq,
                                 const int32_t* __restrict__ change,
                                 const bool* __restrict__ amask,
                                 bool* __restrict__ out, int N, int A) {
  __shared__ int32_t s_fid[kTile];
  __shared__ int32_t s_chg[kTile];
  __shared__ uint8_t s_msk[kTile];
  const size_t row = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(N);
  const int32_t* clk = clock_op + row * static_cast<size_t>(A);

  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool in = i < N;
    const bool live = in && amask[row + i];
    int32_t f_i = 0, c_i = 0, s_i = 0, a_i = -1;
    if (live) {
      f_i = fid[row + i];
      c_i = change[row + i];
      s_i = seq[row + i];
      a_i = actor[row + i];
      if (a_i < 0 || a_i >= A) a_i = -1;  // no clock column: reads 0
    }
    bool hit = false;
    for (int j0 = 0; j0 < N; j0 += kTile) {
      const int nj = min(kTile, N - j0);
      __syncthreads();  // the previous tile is no longer read
      for (int k = threadIdx.x; k < nj; k += blockDim.x) {
        const size_t j = row + j0 + k;
        s_fid[k] = fid[j];
        s_chg[k] = change[j];
        s_msk[k] = amask[j] ? 1 : 0;
      }
      __syncthreads();
      if (live && !hit) {
        for (int k = 0; k < nj; ++k) {
          if (!s_msk[k] || s_fid[k] != f_i || s_chg[k] == c_i) continue;
          const int32_t v =
              a_i < 0 ? 0 : clk[static_cast<size_t>(j0 + k) * A + a_i];
          if (v >= s_i) {
            hit = true;
            break;
          }
        }
      }
    }
    if (in) out[row + i] = hit;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as a pointer); returns
// cudaGetLastError() after the launch, 0 when it was accepted. All arrays
// are contiguous, docs-major; n_docs >= 1, N >= 1, A >= 1.
int amt_dominated(const int32_t* clock_op, const int32_t* actor,
                  const int32_t* fid, const int32_t* seq,
                  const int32_t* change, const bool* amask, bool* out,
                  int n_docs, int N, int A, void* stream) {
  int threads = ((N + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  dominated_kernel<<<n_docs, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      clock_op, actor, fid, seq, change, amask, out, N, A);
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
