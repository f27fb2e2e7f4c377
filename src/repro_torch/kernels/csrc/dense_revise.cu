// One incremental RTAC revise step over dense u8 networks, R rows per launch.
//
// Replaces two TPU kernels of src/repro/kernels/rtac_support.py, which share
// one body:
// - dense_revise_stacked (body _revise_stacked_kernel): each row against its
//   own network, read through instance_idx. It is the stepped fixpoint's
//   revise (one launch per recurrence) — the fallback rung and the parity
//   oracle of the fused kernel (dense_fixpoint.cu). Its kernel is
//   revise_stacked.cuh's, one CTA a row, an entry read as d/8 u64 words; see
//   there for what bounds it and how it is built.
// - dense_revise (body _revise_kernel): B domains against ONE network — the
//   single-network path of enforce/enforce_batch and so of mac_solve; the
//   reference vmaps it. Its kernel is below.
// violated[r, x·d+a] = ∃y: seed[r,y] ∧ mask[x,y] ∧
//                      no byte of (cons2[x·d+a, y·d ..] & dom[r, y·d ..]) is nonzero.
// d is a multiple of 8 (ops.D_MULT), so each (x·a, y) slice is read as d/8
// aligned 8-byte words.
//
// The single-network kernel (that of packed_revise.cu): the Pallas kernel
// walked a grid (r, i, j) and ORed partial results across the sequential
// axis j. Blocks on the card run in no order, so here one block owns one
// (row r, block of kVars variables) output tile and loops over the row's
// seeded y columns itself: no cross-block reduction, no atomics in global
// memory. The row's domain bytes and its compacted seed list sit in shared
// memory. What bounds it on an H100: bytes — the (n*d, d) column slice of
// each seeded y is read once and ANDed once, one byte per constraint bit.
#include "revise_stacked.cuh"

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 256;
constexpr int kVars = 8;  // variables (x) per block

__global__ void __launch_bounds__(kThreads) dense_revise_kernel(
    const uint8_t* __restrict__ cons,     // (C, n*d, n*d) slot table, or one network
    const uint8_t* __restrict__ mask,     // (C, n, n), or one (n, n)
    const int32_t* __restrict__ idx,      // (R,), or null: one network
    const uint8_t* __restrict__ dom_in,   // (R, n*d)
    const uint8_t* __restrict__ seed_in,  // (R, n)
    uint8_t* __restrict__ viol_out,       // (R, n*d)
    int n, int d) {
  extern __shared__ u64 smem[];
  const int nd = n * d;
  const int words = d / 8;
  u64* dom64 = smem;                                                 // (n*d/8,)
  int32_t* seed = reinterpret_cast<int32_t*>(smem + nd / 8);         // (n,)
  uint8_t* viol = reinterpret_cast<uint8_t*>(seed + n);              // (kVars*d,)
  __shared__ int s_count;

  const int r = blockIdx.x;
  const int x0 = blockIdx.y * kVars;
  const int rows = min(kVars, n - x0) * d;
  const int tid = threadIdx.x;
  const size_t slot = idx ? static_cast<size_t>(idx[r]) : 0;
  const uint8_t* c = cons + slot * static_cast<size_t>(nd) * nd;
  const uint8_t* m = mask + slot * static_cast<size_t>(n) * n;

  const u64* dom_row = reinterpret_cast<const u64*>(dom_in + static_cast<size_t>(r) * nd);
  for (int i = tid; i < nd / 8; i += blockDim.x) dom64[i] = dom_row[i];
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
    const u64* cw = reinterpret_cast<const u64*>(c + static_cast<size_t>(row) * nd + y * d);
    const u64* dw = dom64 + y * words;
    u64 support = 0ull;
    for (int j = 0; j < words; ++j) support |= __ldg(cw + j) & dw[j];
    if (support == 0ull) viol[local] = 1;  // benign race: every writer stores 1
  }
  __syncthreads();
  for (int i = tid; i < rows; i += blockDim.x)
    viol_out[static_cast<size_t>(r) * nd + x0 * d + i] = viol[i];
}

}  // namespace

static size_t dense_revise_smem_bytes(int n, int d) {
  return static_cast<size_t>(n) * d + static_cast<size_t>(n) * sizeof(int32_t) +
         static_cast<size_t>(kVars) * d;
}

static int launch_single(const void* cons, const void* mask, const void* dom_in,
                         const void* seed_in, void* viol_out, int rows, int n, int d,
                         void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid(rows, (n + kVars - 1) / kVars);
  dense_revise_kernel<<<grid, kThreads, dense_revise_smem_bytes(n, d),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cons), static_cast<const uint8_t*>(mask), nullptr,
      static_cast<const uint8_t*>(dom_in), static_cast<const uint8_t*>(seed_in),
      static_cast<uint8_t*>(viol_out), n, d);
  return static_cast<int>(cudaGetLastError());
}

// R rows, row r against the slot table's network idx[r]: one CTA a row.
// d/8 = 2 is compiled as a constant, as in dense_fixpoint.cu; any other d/8
// is read at run time.
extern "C" int dense_revise_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* viol_out, int rows, int n, int d, void* stream) {
  const auto run = d / 8 == 2 ? &revise::launch_stacked<u64, 2>
                              : &revise::launch_stacked<u64, 0>;
  return run(cons, mask, idx, dom_in, seed_in, viol_out, rows, n, d, d / 8, stream);
}

// B rows against one network.
extern "C" int dense_revise_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in,
    void* viol_out, int rows, int n, int d, void* stream) {
  return launch_single(cons, mask, dom_in, seed_in, viol_out, rows, n, d, stream);
}
