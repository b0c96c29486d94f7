// RGA linearization of list objects for the docs-major engine, for Hopper.
//
// Replaces no Pallas kernel: the reference computes this step in plain XLA,
// automerge_tpu/engine/kernels.py::linearize (:102-137), a lax.scan of E
// steps plus pointer doubling, vmapped over documents and lists. The port's
// plain version is kernels.linearize_plain. For each row of [R, E] columns
// (ins_mask bool, ins_elem, ins_actor, ins_parent int32) it writes elem_pos
// [R, E] int32:
//   1. the slots in ascending (key, actor, slot) order, key = elem where
//      the mask holds and INT32_MAX where not (the reference's stable
//      lexsort, the plain version's two stable sorts);
//   2. each valid slot in that order head-inserted right after its parent
//      (p = parent + 1, or 0, the head, for a negative parent) in a next
//      array of E + 1 nodes, node 0 the head and slot s at node s + 1: the
//      node takes the parent's successor, the parent takes the node. A
//      parent past the array is dropped on the store and clamped to E on
//      the load, as JAX's scatter and gather do;
//   3. d[v] = the nodes after v, by ceil_log2(E + 1) synchronous pointer-
//      doubling steps (every node, detached ones and cycles included, gets
//      the same d as the plain version's);
//   4. elem_pos[s] = d[0] - d[s + 1] - 1, masked slots included.
//
// What bounds it on an H100: the function reads 17 bytes a slot (the mask
// byte and three int32 columns) and writes 4, at 3.35 TB/s. But step 2 is
// E dependent read-modify-writes of the next array per row, a latency
// chain no thread count shortens; rows run in parallel across the grid.
//
// Design, for correctness first: one block per row, the row's columns,
// its order, next and distance arrays (7 * (E + 1) ints) in shared memory,
// all threads on the rank of every slot in the order (a count over the
// row: O(E^2) compares, E / threads a thread), one thread on the walk,
// all threads on the doubling with a barrier a step. A row whose arrays
// do not fit a block's shared memory works in a global scratch instead,
// one slice per block, the grid capped by the caller and each block
// looping over rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInt32Max = 0x7fffffff;
constexpr int kMaxDevices = 64;
constexpr int kArrays = 7;

__global__ void __launch_bounds__(1024)
linearize_kernel(const bool* __restrict__ mask,
                 const int32_t* __restrict__ elem,
                 const int32_t* __restrict__ actor,
                 const int32_t* __restrict__ parent,
                 int32_t* __restrict__ out, int32_t* scratch, int R, int E,
                 int steps) {
  extern __shared__ __align__(16) int32_t smem[];
  const int stride = E + 1;
  int32_t* work = scratch == nullptr
                      ? smem
                      : scratch + static_cast<size_t>(blockIdx.x) *
                                      kArrays * stride;
  int32_t* key = work;             // sort key of each slot
  int32_t* act = key + stride;     // actor of each slot
  int32_t* pv = act + stride;      // parent node p, or -1 for a masked slot
  int32_t* nxt = pv + stride;      // next pointers, then doubling buffer A
  int32_t* dst = nxt + stride;     // distances, buffer A
  int32_t* oslot = dst + stride;   // order: node to insert at step t (B)
  int32_t* ordp = oslot + stride;  // order: its parent node (B)
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * E;
    for (int s = tid; s < E; s += nt) {
      const bool m = mask[row + s];
      key[s] = m ? elem[row + s] : kInt32Max;
      act[s] = actor[row + s];
      const long long par = parent[row + s];
      const long long p = par >= 0 ? par + 1 : 0;
      // past the array: E + 1 stands for "clamp the load, drop the store"
      pv[s] = m ? static_cast<int32_t>(p > E ? E + 1 : p) : -1;
    }
    for (int v = tid; v <= E; v += nt) nxt[v] = -1;
    __syncthreads();

    // 1. the position of each slot in (key, actor, slot) order
    for (int s = tid; s < E; s += nt) {
      const int32_t key_s = key[s], act_s = act[s];
      int pos = 0;
      for (int j = 0; j < E; ++j) {
        const int32_t key_j = key[j], act_j = act[j];
        pos += (key_j < key_s) |
               ((key_j == key_s) &
                ((act_j < act_s) | ((act_j == act_s) & (j < s))));
      }
      oslot[pos] = pv[s] >= 0 ? s + 1 : -1;
      ordp[pos] = pv[s];
    }
    __syncthreads();

    // 2. the sequential walk: one thread, E dependent steps
    if (tid == 0) {
      for (int t = 0; t < E; ++t) {
        const int32_t node = oslot[t];
        if (node < 0) continue;
        const int32_t p = ordp[t];
        const int32_t succ = nxt[p > E ? E : p];
        nxt[node] = succ;
        if (p <= E) nxt[p] = node;
      }
    }
    __syncthreads();

    // 3. pointer doubling, buffers A (nxt, dst) and B (oslot, ordp)
    for (int v = tid; v <= E; v += nt) dst[v] = nxt[v] >= 0 ? 1 : 0;
    __syncthreads();
    int32_t *na = nxt, *da = dst, *nb = oslot, *db = ordp;
    for (int k = 0; k < steps; ++k) {
      for (int v = tid; v <= E; v += nt) {
        const int32_t n = na[v];
        if (n >= 0) {
          db[v] = da[v] + da[n];
          nb[v] = na[n];
        } else {
          db[v] = da[v];
          nb[v] = -1;
        }
      }
      __syncthreads();
      int32_t* t = na; na = nb; nb = t;
      t = da; da = db; db = t;
    }

    // 4. positions
    const int32_t total = da[0];
    for (int s = tid; s < E; s += nt) out[row + s] = total - da[s + 1] - 1;
    __syncthreads();  // the next row reuses the arrays
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of the current device may opt in to (the
// wrapper sends a row to the global scratch when its arrays need more), or
// the negated CUDA error.
int amt_linearize_smem_limit(void) {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

// Launch on `stream` (a cudaStream_t as a pointer) with `grid` blocks;
// returns cudaGetLastError() after the launch. All arrays are contiguous
// [R, E]; R >= 1, 1 <= E. scratch == nullptr: a row's 7 * (E + 1) ints in
// shared memory (grid = R); else scratch holds grid * 7 * (E + 1) ints and
// each block loops over rows. steps = ceil_log2(E + 1), at least 1.
int amt_linearize(const bool* mask, const int32_t* elem,
                  const int32_t* actor, const int32_t* parent, int32_t* out,
                  int32_t* scratch, int R, int E, int steps, int grid,
                  void* stream) {
  static int opted[kMaxDevices] = {};
  const int threads = E + 1 >= 1024 ? 1024 : (E + 1 + 31) / 32 * 32;
  size_t bytes = 0;
  if (scratch == nullptr) {
    bytes = static_cast<size_t>(kArrays) * (E + 1) * sizeof(int32_t);
    if (bytes > 48 * 1024) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev >= kMaxDevices || opted[dev] < static_cast<int>(bytes)) {
        const int limit = amt_linearize_smem_limit();
        if (limit < 0) return -limit;
        if (static_cast<int>(bytes) > limit)
          return static_cast<int>(cudaErrorInvalidValue);
        e = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(linearize_kernel),
            cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (dev < kMaxDevices) opted[dev] = limit;
      }
    }
  }
  linearize_kernel<<<grid, threads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      mask, elem, actor, parent, out, scratch, R, E, steps);
  return static_cast<int>(cudaGetLastError());
}

const char* amt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
