// Fused incremental RTAC fixpoint over bitpacked networks, R rows per launch.
//
// Replaces the TPU kernel src/repro/kernels/bitpack_support.py::
// packed_fixpoint_stacked (body _fixpoint_packed_stacked_kernel): every row
// runs its own Jacobi recurrence to convergence inside one launch —
// support test = any word of (cons & dom) nonzero, dom &= ~violated,
// k += 1 per sweep the row was active — and the launch writes the unpacked
// domain, the consistency bit and k.
//
// What bounds it on an H100: bytes. One sweep of a row reads, for each
// variable y of its seed, the (n*d, W) column slice of its network (4 B a
// word) and does one AND per word; there is no reuse to feed the ALUs, so the
// constraint words streamed from L2/HBM set the time.
//
// Design:
// - One CTA per row; rows are independent, so no grid-wide sync. The domain
//   words, the changed flags, the compacted seed list and the violation bits
//   of the current sweep live in shared memory; __syncthreads() separates
//   the sweeps.
// - The row's network is read in place from the slot table through
//   instance_idx (no gathered copy of the networks per round). The Pallas
//   kernel kept a block of networks in VMEM; 227 KB of shared memory cannot
//   hold one 3.5 MB network, so each sweep streams the words it needs.
// - Only the seed's y columns are swept (Prop. 2): a one-hot seed after an
//   assignment reads n*d*W words, not n*d*n*W. The result equals the masked
//   full sweep of the reference.
// - Threads take (row (x,a), seed y) pairs with consecutive threads on
//   consecutive seed entries, so a dense seed reads a network row's words in
//   order; a violated (x,a) sets its bit with a shared-memory atomicOr.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) packed_fixpoint_kernel(
    const uint32_t* __restrict__ cons,     // (C, n*d, n*w) slot table
    const uint8_t* __restrict__ mask,      // (C, n, n)
    const int32_t* __restrict__ idx,       // (R,) row -> table slot
    const uint32_t* __restrict__ dom_in,   // (R, n*w) packed domains
    const uint8_t* __restrict__ seed_in,   // (R, n) Prop. 2 revision seed
    uint8_t* __restrict__ dom_out,         // (R, n*d) unpacked closure
    uint8_t* __restrict__ consistent_out,  // (R,)
    int32_t* __restrict__ k_out,           // (R,)
    int n, int d, int w) {
  extern __shared__ uint32_t smem[];
  const int nw = n * w;
  const int nd = n * d;
  uint32_t* words = smem;                                       // (n, w)
  uint32_t* viol = smem + nw;                                   // (n, w)
  int32_t* seed = reinterpret_cast<int32_t*>(smem + 2 * nw);    // (n,)
  uint8_t* changed = reinterpret_cast<uint8_t*>(seed + n);      // (n,)
  __shared__ int s_count;
  __shared__ int s_alive;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t slot = static_cast<size_t>(idx[r]);
  const uint32_t* c = cons + slot * static_cast<size_t>(nd) * nw;
  const uint8_t* m = mask + slot * static_cast<size_t>(n) * n;

  if (tid == 0) s_alive = 1;
  for (int i = tid; i < nw; i += blockDim.x) words[i] = dom_in[static_cast<size_t>(r) * nw + i];
  __syncthreads();
  for (int x = tid; x < n; x += blockDim.x) {
    uint32_t any = 0;
    for (int j = 0; j < w; ++j) any |= words[x * w + j];
    if (any == 0) s_alive = 0;
  }
  __syncthreads();
  bool consistent = s_alive != 0;
  for (int x = tid; x < n; x += blockDim.x)
    changed[x] = consistent && seed_in[static_cast<size_t>(r) * n + x] != 0;
  int k = 0;
  __syncthreads();

  while (true) {
    if (tid == 0) {  // compact the seed: the y columns this sweep must read
      int count = 0;
      for (int y = 0; y < n; ++y)
        if (changed[y]) seed[count++] = y;
      s_count = count;
      s_alive = 1;
    }
    for (int i = tid; i < nw; i += blockDim.x) viol[i] = 0u;
    __syncthreads();
    const int count = s_count;
    if (!consistent || count == 0) break;  // uniform across the block

    const int pairs = nd * count;
    for (int p = tid; p < pairs; p += blockDim.x) {
      const int row = p / count;
      const int y = seed[p - row * count];
      const int x = row / d;
      if (!m[x * n + y]) continue;  // unconstrained pair: always supported
      const uint32_t* cw = c + static_cast<size_t>(row) * nw + y * w;
      const uint32_t* dw = words + y * w;
      uint32_t support = 0u;
      for (int j = 0; j < w; ++j) support |= __ldg(cw + j) & dw[j];
      if (support == 0u) {
        const int a = row - x * d;
        atomicOr(&viol[x * w + (a >> 5)], 1u << (a & 31));
      }
    }
    __syncthreads();
    for (int x = tid; x < n; x += blockDim.x) {
      uint32_t diff = 0u, alive = 0u;
      for (int j = 0; j < w; ++j) {
        const uint32_t old = words[x * w + j];
        const uint32_t kept = old & ~viol[x * w + j];
        words[x * w + j] = kept;
        diff |= old ^ kept;
        alive |= kept;
      }
      changed[x] = diff != 0u;
      if (alive == 0u) s_alive = 0;
    }
    __syncthreads();
    consistent = consistent && s_alive != 0;
    k += 1;
    __syncthreads();  // everyone has read s_alive before thread 0 resets it
  }

  for (int i = tid; i < nd; i += blockDim.x) {
    const int x = i / d;
    const int a = i - x * d;
    dom_out[static_cast<size_t>(r) * nd + i] =
        static_cast<uint8_t>((words[x * w + (a >> 5)] >> (a & 31)) & 1u);
  }
  if (tid == 0) {
    consistent_out[r] = consistent ? 1 : 0;
    k_out[r] = k;
  }
}

}  // namespace

static size_t packed_fixpoint_smem_bytes(int n, int w) {
  return static_cast<size_t>(2 * n * w + n) * sizeof(uint32_t) + static_cast<size_t>(n);
}

extern "C" int packed_fixpoint_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, int w, void* stream) {
  if (rows <= 0) return 0;
  packed_fixpoint_kernel<<<rows, kThreads, packed_fixpoint_smem_bytes(n, w),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cons), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(idx), static_cast<const uint32_t*>(dom_in),
      static_cast<const uint8_t*>(seed_in), static_cast<uint8_t*>(dom_out),
      static_cast<uint8_t*>(consistent_out), static_cast<int32_t*>(k_out), n, d, w);
  return static_cast<int>(cudaGetLastError());
}
