// Fused incremental RTAC fixpoint over dense u8 networks, R rows per launch.
//
// Replaces the TPU kernel src/repro/kernels/rtac_support.py::
// dense_fixpoint_stacked (body _fixpoint_stacked_kernel): every row runs its
// own Jacobi recurrence to convergence inside one launch — support test =
// any byte of (cons2[x·d+a, y·d .. y·d+d) & dom[y·d .. y·d+d)) nonzero,
// dom &= ~violated, k += 1 per sweep the row was active — and the launch
// writes the domain bytes, the consistency bit and k.
//
// What bounds it on an H100: bytes. One sweep of a row reads, for each
// variable y of its seed, the (n*d, d) column slice of its network (one byte
// per constraint bit, 8x the packed kernel's traffic) and does one AND per
// byte; there is no reuse to feed the ALUs.
//
// Design (that of packed_fixpoint.cu):
// - One CTA per row; rows are independent, so no grid-wide sync. The domain
//   bytes, the changed flags, the compacted seed list and the violation
//   flags of the current sweep live in shared memory (about 8.8 KB at
//   n=104, d=40); __syncthreads() separates the sweeps.
// - The row's network is read in place from the slot table through
//   instance_idx (no gathered copy of the networks per round). A 17 MB dense
//   network cannot sit in 227 KB of shared memory, so each sweep streams the
//   bytes it needs.
// - Only the seed's y columns are swept (Prop. 2): the result equals the
//   masked full sweep of the reference.
// - Threads take (row (x,a), seed y) pairs with consecutive threads on
//   consecutive seed entries. d is a multiple of 8 (ops.D_MULT), so the
//   support test reads the slice as d/8 aligned 8-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) dense_fixpoint_kernel(
    const uint8_t* __restrict__ cons,      // (C, n*d, n*d) slot table
    const uint8_t* __restrict__ mask,      // (C, n, n)
    const int32_t* __restrict__ idx,       // (R,) row -> table slot
    const uint8_t* __restrict__ dom_in,    // (R, n*d) domain bytes
    const uint8_t* __restrict__ seed_in,   // (R, n) Prop. 2 revision seed
    uint8_t* __restrict__ dom_out,         // (R, n*d) closure
    uint8_t* __restrict__ consistent_out,  // (R,)
    int32_t* __restrict__ k_out,           // (R,)
    int n, int d) {
  extern __shared__ u64 smem[];
  const int nd = n * d;
  const int words = d / 8;  // 8-byte words of one (x·a, y) slice
  uint8_t* dom = reinterpret_cast<uint8_t*>(smem);              // (n*d,), 8-byte aligned
  const u64* dom64 = smem;
  int32_t* seed = reinterpret_cast<int32_t*>(dom + nd);         // (n,)
  uint8_t* viol = reinterpret_cast<uint8_t*>(seed + n);         // (n*d,)
  uint8_t* changed = viol + nd;                                 // (n,)
  __shared__ int s_count;
  __shared__ int s_alive;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t slot = static_cast<size_t>(idx[r]);
  const uint8_t* c = cons + slot * static_cast<size_t>(nd) * nd;
  const uint8_t* m = mask + slot * static_cast<size_t>(n) * n;

  if (tid == 0) s_alive = 1;
  for (int i = tid; i < nd; i += blockDim.x) dom[i] = dom_in[static_cast<size_t>(r) * nd + i];
  __syncthreads();
  for (int x = tid; x < n; x += blockDim.x) {
    uint8_t any = 0;
    for (int a = 0; a < d; ++a) any |= dom[x * d + a];
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
    for (int i = tid; i < nd; i += blockDim.x) viol[i] = 0;
    __syncthreads();
    const int count = s_count;
    if (!consistent || count == 0) break;  // uniform across the block

    const int pairs = nd * count;
    for (int p = tid; p < pairs; p += blockDim.x) {
      const int row = p / count;
      const int y = seed[p - row * count];
      const int x = row / d;
      if (!m[x * n + y]) continue;  // unconstrained pair: always supported
      const u64* cw = reinterpret_cast<const u64*>(c + static_cast<size_t>(row) * nd + y * d);
      const u64* dw = dom64 + y * words;
      u64 support = 0ull;
      for (int j = 0; j < words; ++j) support |= __ldg(cw + j) & dw[j];
      if (support == 0ull) viol[row] = 1;  // benign race: every writer stores 1
    }
    __syncthreads();
    for (int x = tid; x < n; x += blockDim.x) {
      uint8_t diff = 0, alive = 0;
      for (int a = 0; a < d; ++a) {
        const uint8_t old = dom[x * d + a];
        const uint8_t kept = old & static_cast<uint8_t>(~viol[x * d + a]);
        dom[x * d + a] = kept;
        diff |= old ^ kept;
        alive |= kept;
      }
      changed[x] = diff != 0;
      if (alive == 0) s_alive = 0;
    }
    __syncthreads();
    consistent = consistent && s_alive != 0;
    k += 1;
    __syncthreads();  // everyone has read s_alive before thread 0 resets it
  }

  for (int i = tid; i < nd; i += blockDim.x) dom_out[static_cast<size_t>(r) * nd + i] = dom[i];
  if (tid == 0) {
    consistent_out[r] = consistent ? 1 : 0;
    k_out[r] = k;
  }
}

}  // namespace

static size_t dense_fixpoint_smem_bytes(int n, int d) {
  return 2 * static_cast<size_t>(n) * d + static_cast<size_t>(n) * (sizeof(int32_t) + 1);
}

extern "C" int dense_fixpoint_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, void* stream) {
  if (rows <= 0) return 0;
  dense_fixpoint_kernel<<<rows, kThreads, dense_fixpoint_smem_bytes(n, d),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cons), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(dom_in),
      static_cast<const uint8_t*>(seed_in), static_cast<uint8_t*>(dom_out),
      static_cast<uint8_t*>(consistent_out), static_cast<int32_t*>(k_out), n, d);
  return static_cast<int>(cudaGetLastError());
}
