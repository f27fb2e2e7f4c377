// The word loop's epilogue: one recurrence's bookkeeping after kernel 3.
//
// The fused packed engine runs a single network's fixpoint where the fused
// CTA does not fit (kernels/ops.py `packed_word_fixpoint`) as a loop of
// packed_revise launches (kernel 3, packed_revise.cu) on the rows' packed
// domains, each followed by this kernel. It keeps the whole state of the
// loop on the card as packed words and flags, so the host enqueues a chunk
// of recurrences and reads one count a chunk:
//
//   words (B, n·W) u32   the domains, updated in place
//   viol  (B, n·d) u8    kernel 3's violations of this recurrence (0 or 1)
//   seed  (B, n)   u8    this recurrence's seed in, the next one's out
//   consistent (B,) u8 out, k (B,) int32, counts (2,) int32
//
// One CTA a row. A row is active in this recurrence iff it has a seed and
// no empty domain (the host loop's `consistent & any(changed)`: the seeds
// given on entry, and later exactly the seeds this kernel wrote). A row
// that is not active keeps its words and k; its seed is cleared and
// `consistent` is whether no domain is empty. An active row: words[x] &=
// ~(x's violation bits); seed[x] = whether x's domain changed; consistent
// = no domain is empty; k += 1; a row no longer active (wiped out, or
// nothing changed) gets a zero seed. Then counts[0] += 1 (rows revised)
// and, if still active, counts[1] += 1 (rows left to revise). Per row this
// is the host loop's recurrence (core/rtac.py `_fixpoint_rows`), so the
// closures, verdicts and k are the same at any chunk length.
//
// Its plain version is bitpack_support.packed_word_epilogue_plain. d is a
// multiple of 8 (ops.D_MULT), so x's violation bytes are read as d/8
// aligned 8-byte words; a thread owns a variable at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// Byte q of v nonzero -> bit q of the result.
__device__ __forceinline__ uint32_t byte_bits(unsigned long long v) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    bits |= static_cast<uint32_t>(((v >> (8 * q)) & 0xffull) != 0) << q;
  return bits;
}

// Whether some domain of the row (n variables of w words) is empty.
__device__ __forceinline__ bool some_empty(const uint32_t* row, int n, int w) {
  bool empty = false;
  for (int x = threadIdx.x; x < n; x += kThreads) {
    bool live = false;
    for (int i = 0; i < w; ++i) live |= row[static_cast<size_t>(x) * w + i] != 0;
    empty |= !live;
  }
  return __syncthreads_or(empty);
}

__global__ void __launch_bounds__(kThreads) word_epilogue_kernel(
    uint32_t* __restrict__ words, const uint8_t* __restrict__ viol, uint8_t* __restrict__ seed,
    uint8_t* __restrict__ consistent, int* __restrict__ k, int* __restrict__ counts, int n,
    int d, int w) {
  const int r = blockIdx.x;
  uint32_t* row = words + static_cast<size_t>(r) * n * w;
  const uint8_t* vrow = viol + static_cast<size_t>(r) * n * d;
  uint8_t* srow = seed + static_cast<size_t>(r) * n;
  bool seeded = false;
  for (int x = threadIdx.x; x < n; x += kThreads) seeded |= srow[x] != 0;
  const bool any_seed = __syncthreads_or(seeded);
  const bool dead = some_empty(row, n, w);
  if (!any_seed || dead) {  // not active: nothing moves
    if (any_seed)
      for (int x = threadIdx.x; x < n; x += kThreads) srow[x] = 0;
    if (threadIdx.x == 0) consistent[r] = !dead;
    return;
  }
  bool changed = false, wiped = false;
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const unsigned long long* v =
        reinterpret_cast<const unsigned long long*>(vrow + static_cast<size_t>(x) * d);
    bool ch = false, live = false;
    for (int i = 0; i < w; ++i) {  // word i holds values [32i, 32i + 32)
      uint32_t bits = 0;
      for (int j = 4 * i; j < 4 * i + 4 && 8 * j < d; ++j)
        bits |= byte_bits(v[j]) << (8 * (j & 3));
      uint32_t* at = row + static_cast<size_t>(x) * w + i;
      const uint32_t old = *at, now = old & ~bits;
      if (now != old) {
        *at = now;
        ch = true;
      }
      live |= now != 0;
    }
    srow[x] = ch;
    changed |= ch;
    wiped |= !live;
  }
  const bool any_changed = __syncthreads_or(changed);
  const bool any_wiped = __syncthreads_or(wiped);
  const bool next = any_changed && !any_wiped;
  if (!next)
    for (int x = threadIdx.x; x < n; x += kThreads) srow[x] = 0;
  if (threadIdx.x == 0) {
    k[r] += 1;
    consistent[r] = !any_wiped;
    atomicAdd(counts, 1);
    if (next) atomicAdd(counts + 1, 1);
  }
}

}  // namespace

// B rows of n variables, W words and d values (a multiple of 8) each; the
// tensors as above, `viol` 8-byte aligned.
extern "C" int packed_word_epilogue_launch(void* words, const void* viol, void* seed,
                                           void* consistent, void* k, void* counts, int rows,
                                           int n, int d, int w, void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || d <= 0 || (d & 7) != 0 || w != (d + 31) / 32 ||
      (reinterpret_cast<uintptr_t>(viol) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  word_epilogue_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<const uint8_t*>(viol),
      static_cast<uint8_t*>(seed), static_cast<uint8_t*>(consistent), static_cast<int*>(k),
      static_cast<int*>(counts), n, d, w);
  return static_cast<int>(cudaGetLastError());
}
