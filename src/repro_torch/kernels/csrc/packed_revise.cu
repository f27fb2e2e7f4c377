// One incremental RTAC revise step over bitpacked networks, R rows per launch.
//
// Replaces two TPU kernels of src/repro/kernels/bitpack_support.py, which
// share one body:
// - packed_revise_stacked (body _revise_packed_stacked_kernel): each row
//   against its own network, read through instance_idx. It is the stepped
//   fixpoint's revise (one launch per recurrence) — the fallback rung and the
//   parity oracle of the fused kernel. Its kernel is revise_stacked.cuh's,
//   one CTA a row, with u32 words (W per entry); see there for what bounds it
//   and how it is built.
// - packed_revise (body _revise_packed_kernel): B domains against ONE
//   network — the single-network path of enforce/enforce_batch and so of
//   mac_solve; the reference vmaps it. Its kernel is below.
// violated[r, x·d+a] = ∃y: seed[r,y] ∧ mask[x,y] ∧ (cons[x·d+a, y·W..] & dom[r, y·W..]) == 0.
//
// The single-network kernel: the Pallas kernel walked a grid (r, i, j) and
// ORed partial results across the sequential axis j. Blocks on the card run
// in no order, so here one block owns one (row r, block of kVars variables)
// output tile and loops over the row's seeded y columns itself: no
// cross-block reduction, no atomics in global memory. The row's domain words
// and its compacted seed list sit in shared memory. What bounds it on an
// H100: bytes — the (n*d, W) column slice of each seeded y is read once and
// ANDed once.
#include "revise_stacked.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVars = 8;  // variables (x) per block

__global__ void __launch_bounds__(kThreads) packed_revise_kernel(
    const uint32_t* __restrict__ cons,    // (C, n*d, n*w) slot table
    const uint8_t* __restrict__ mask,     // (C, n, n)
    const int32_t* __restrict__ idx,      // (R,), or null: one network
    const uint32_t* __restrict__ dom_in,  // (R, n*w)
    const uint8_t* __restrict__ seed_in,  // (R, n)
    uint8_t* __restrict__ viol_out,       // (R, n*d)
    int n, int d, int w) {
  extern __shared__ uint32_t smem[];
  const int nw = n * w;
  const int nd = n * d;
  uint32_t* words = smem;                                     // (n, w)
  int32_t* seed = reinterpret_cast<int32_t*>(smem + nw);      // (n,)
  uint8_t* viol = reinterpret_cast<uint8_t*>(seed + n);       // (kVars*d,)
  __shared__ int s_count;

  const int r = blockIdx.x;
  const int x0 = blockIdx.y * kVars;
  const int rows = min(kVars, n - x0) * d;
  const int tid = threadIdx.x;
  const size_t slot = idx ? static_cast<size_t>(idx[r]) : 0;
  const uint32_t* c = cons + slot * static_cast<size_t>(nd) * nw;
  const uint8_t* m = mask + slot * static_cast<size_t>(n) * n;

  for (int i = tid; i < nw; i += blockDim.x) words[i] = dom_in[static_cast<size_t>(r) * nw + i];
  for (int i = tid; i < rows; i += blockDim.x) viol[i] = 0;
  if (tid == 0) {
    int count = 0;
    for (int y = 0; y < n; ++y)
      if (seed_in[static_cast<size_t>(r) * n + y]) seed[count++] = y;
    s_count = count;
  }
  __syncthreads();
  const int count = s_count;

  const int pairs = rows * count;
  for (int p = tid; p < pairs; p += blockDim.x) {
    const int local = p / count;
    const int y = seed[p - local * count];
    const int row = x0 * d + local;
    const int x = row / d;
    if (!m[x * n + y]) continue;
    const uint32_t* cw = c + static_cast<size_t>(row) * nw + y * w;
    const uint32_t* dw = words + y * w;
    uint32_t support = 0u;
    for (int j = 0; j < w; ++j) support |= __ldg(cw + j) & dw[j];
    if (support == 0u) viol[local] = 1;  // benign race: every writer stores 1
  }
  __syncthreads();
  for (int i = tid; i < rows; i += blockDim.x)
    viol_out[static_cast<size_t>(r) * nd + x0 * d + i] = viol[i];
}

}  // namespace

static size_t packed_revise_smem_bytes(int n, int d, int w) {
  return static_cast<size_t>(n * w + n) * sizeof(uint32_t) + static_cast<size_t>(kVars * d);
}

static int launch_single(const void* cons, const void* mask, const void* dom_in,
                         const void* seed_in, void* viol_out, int rows, int n, int d, int w,
                         void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid(rows, (n + kVars - 1) / kVars);
  packed_revise_kernel<<<grid, kThreads, packed_revise_smem_bytes(n, d, w),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cons), static_cast<const uint8_t*>(mask), nullptr,
      static_cast<const uint32_t*>(dom_in), static_cast<const uint8_t*>(seed_in),
      static_cast<uint8_t*>(viol_out), n, d, w);
  return static_cast<int>(cudaGetLastError());
}

// R rows, row r against the slot table's network idx[r]: one CTA a row.
// An entry of W = 2 words is read as one 8-byte word where the table and
// the domains are 8-byte aligned; W = 1 is a constant too; any other W is
// read at run time.
extern "C" int packed_revise_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* viol_out, int rows, int n, int d, int w, void* stream) {
  const bool wide = w == 2 && ((reinterpret_cast<uintptr_t>(cons) |
                                reinterpret_cast<uintptr_t>(dom_in)) & 7) == 0;
  if (wide)
    return revise::launch_stacked<revise::u64, 1>(cons, mask, idx, dom_in, seed_in, viol_out,
                                                  rows, n, d, 1, stream);
  const auto run = w == 1 ? &revise::launch_stacked<uint32_t, 1>
                          : &revise::launch_stacked<uint32_t, 0>;
  return run(cons, mask, idx, dom_in, seed_in, viol_out, rows, n, d, w, stream);
}

// B rows against one network.
extern "C" int packed_revise_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in,
    void* viol_out, int rows, int n, int d, int w, void* stream) {
  return launch_single(cons, mask, dom_in, seed_in, viol_out, rows, n, d, w, stream);
}
