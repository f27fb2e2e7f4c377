// Fused incremental RTAC fixpoint over bitpacked networks, R rows per launch.
//
// Replaces the TPU kernel src/repro/kernels/bitpack_support.py::
// packed_fixpoint_stacked (body _fixpoint_packed_stacked_kernel): every row
// runs its own Jacobi recurrence to convergence inside one launch —
// support test = any word of (cons & dom) nonzero, dom &= ~violated,
// k += 1 per sweep the row was active — and the launch writes the unpacked
// domain, the consistency bit and k.
//
// What bounded the first design (one thread per (x·a, seeded y) pair, one
// CTA per row): bookkeeping and the one-CTA tail, not bytes. Each pair cost
// two integer divisions, a shared load and a global mask load before the
// mask said whether it was constrained at all; at the main shape (Model RB
// n=100, d=40) 6.5 % of the mask is set, so a root sweep walked 432,640
// pairs to find 25,840 constrained ones, and the launch waited for the root
// rows that one CTA walked alone. The dense kernel, reading five times the
// bytes, took only 1.13× as long on an H100 (PERF.md): bytes did not set
// the time.
//
// Design (fixpoint_common.cuh; dense_fixpoint.cu shares it):
// - Walk only constrained pairs. The row's mask sits in shared memory as
//   bits; each sweep a warp forms its seed bits with ballots, and
//   for each variable x it owns builds the list of x's seeded neighbours
//   (mask bits & seed bits) and the list of values still in x's domain, with
//   popc prefix sums. It tests exactly (value × neighbour) pairs: no
//   division, no mask load, no test of a value already gone. The lists are
//   per variable and at most n and d long, so nothing overflows and no seed
//   is cut into chunks.
// - Lanes over the pairs, neighbours fastest: with one seeded neighbour
//   (the common one-hot seed) the lanes run over values; with many they run
//   over neighbours and read consecutive words of one network row. Each lane
//   keeps 4 tests in flight, 8 for one-word entries. W = 1 and 2 (the
//   driven shapes) are compiled as constants, which measured 10-36 % faster
//   than reading W at run time at W = 2 (PERF.md); any other W is read at
//   run time.
// - One pass and one barrier per sweep. The owner warp applies x's removals,
//   detects its change and wipe-out, and writes the result into the other
//   domain buffer (Jacobi: every test of the sweep reads the buffer as it was
//   when the sweep began).
// - One CTA per row. Splitting a row over a thread-block cluster was
//   measured (PERF.md) and gained only at a shape the main path does not
//   run, so it is not built.
// - The row's network is read in place from the slot table through
//   instance_idx; 227 KB of shared memory cannot hold one 3.5 MB network.
//
// What bounds it now (measured on an H100, PERF.md): memory sectors. A test
// reads one W-word entry, 8 bytes at the main shape, of a 32-byte sector
// whose other entries belong to neighbours that are seldom seeded, from
// tables larger than L2; batching a warp's variables to keep more tests in
// flight measured no faster. The table layout, the reference's, sets that
// cost.
#include "fixpoint_common.cuh"

namespace {

using namespace fixpoint;

// The values still in x's domain words (bits of values >= d ignored).
__device__ __forceinline__ int packed_values(const uint32_t* words, int d, int w,
                                             uint16_t* values, int lane) {
  int count = 0;
  for (int j = 0; j < w; ++j) {
    uint32_t bits = words[j];
    const int left = d - 32 * j;
    if (left < 32) bits &= (1u << left) - 1u;
    count = append_bits(values, count, bits, 32 * j, lane);
  }
  return count;
}

template <int KW>  // words per entry (W), or 0: read w at run time
__global__ void __launch_bounds__(kThreads) packed_fixpoint_kernel(
    const uint32_t* __restrict__ cons,     // (C, n*d, n*w) slot table
    const uint8_t* __restrict__ mask,      // (C, n, n)
    const int32_t* __restrict__ idx,       // (R,) row -> table slot
    const uint32_t* __restrict__ dom_in,   // (R, n*w) packed domains
    const uint8_t* __restrict__ seed_in,   // (R, n) Prop. 2 revision seed
    uint8_t* __restrict__ dom_out,         // (R, n*d) unpacked closure
    uint8_t* __restrict__ consistent_out,  // (R,)
    int32_t* __restrict__ k_out,           // (R,)
    int n, int d, int w_arg) {
  const int w = KW > 0 ? KW : w_arg;
  const int nw = n * w, nwn = (n + 31) / 32;
  const Smem L(n, d, 4 * nw);
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* const dom0 = reinterpret_cast<uint32_t*>(smem);  // the two domain buffers
  uint32_t* const dom1 = dom0 + nw;
  const uint32_t* mbits = reinterpret_cast<const uint32_t*>(smem + L.mbits);
  uint32_t* seed = reinterpret_cast<uint32_t*>(smem + L.seed) + warp * nwn;
  uint32_t* viol = reinterpret_cast<uint32_t*>(smem + L.viol) + warp * w;
  uint32_t* dead = reinterpret_cast<uint32_t*>(smem + L.dead);  // [2], written like next
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem + L.ys) + warp * n;
  uint16_t* values = reinterpret_cast<uint16_t*>(smem + L.values) + warp * d;
  uint8_t* const changed0 = smem + L.changed;  // and the two buffers of changed flags
  uint8_t* const changed1 = changed0 + n;

  const int r = blockIdx.x;
  const size_t slot = static_cast<size_t>(idx[r]);
  const uint32_t* net = cons + slot * static_cast<size_t>(n * d) * nw;

  for (int i = threadIdx.x; i < nw; i += kThreads)
    dom0[i] = dom_in[static_cast<size_t>(r) * nw + i];
  for (int x = threadIdx.x; x < n; x += kThreads)
    changed0[x] = seed_in[static_cast<size_t>(r) * n + x] != 0;
  if (threadIdx.x < 2) dead[threadIdx.x] = 0u;
  load_mask_bits(mask + slot * n * n, smem + L.mbits, n);
  __syncthreads();
  bool empty = false;  // a variable with no value at entry: the row does no sweep
  for (int x = threadIdx.x; x < n; x += kThreads) {
    uint32_t any = 0;
    for (int j = 0; j < w; ++j) any |= dom0[x * w + j];
    empty |= any == 0;
  }
  bool consistent = !__syncthreads_or(empty);

  int k = 0, p = 0;
  while (consistent && seed_bits(p ? changed1 : changed0, seed, n, lane)) {
    const uint32_t* cur = p ? dom1 : dom0;
    uint32_t* next = p ? dom0 : dom1;
    uint8_t* next_changed = p ? changed0 : changed1;
    for (int x0 = warp; x0 < n; x0 += 32 * kWarps) {  // this warp owns x ≡ warp mod 8
      const int x = x0 + lane * kWarps;  // one owned variable per lane
      const bool hit = x < n && constrained(mbits + x * nwn, seed, nwn);
      if (x < n && !hit) {  // no seeded neighbour: x keeps its domain
        for (int j = 0; j < w; ++j) next[x * w + j] = cur[x * w + j];
        next_changed[x] = 0;
      }
      for (uint32_t todo = __ballot_sync(kFull, hit); todo; todo &= todo - 1) {
        const int xv = x0 + (__ffs(todo) - 1) * kWarps;  // the whole warp revises xv
        const uint32_t* words = cur + xv * w;
        const int nv = packed_values(words, d, w, values, lane);
        const int m = neighbours(mbits + xv * nwn, seed, nwn, ys, lane);
        for (int j = lane; j < w; j += 32) viol[j] = 0u;
        __syncwarp();
        test_supports<uint32_t, KW>(net, cur, xv, n, d, w, values, nv, ys, m, viol, lane);
        __syncwarp();
        bool diff = false, alive = false;
        for (int j = lane; j < w; j += 32) {
          const uint32_t kept = words[j] & ~viol[j];
          diff |= kept != words[j];
          alive |= kept != 0u;
          next[xv * w + j] = kept;
        }
        diff = __any_sync(kFull, diff);
        alive = __any_sync(kFull, alive);
        if (lane == 0) {
          next_changed[xv] = diff;
          if (!alive) dead[p ^ 1] = 1u;
        }
        __syncwarp();  // the lists and viol are reused for the next variable
      }
    }
    __syncthreads();
    consistent = dead[p ^ 1] == 0u;
    p ^= 1;
    ++k;
  }

  const uint32_t* fin = p ? dom1 : dom0;
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int x = i / d, a = i - x * d;
    dom_out[static_cast<size_t>(r) * n * d + i] =
        static_cast<uint8_t>((fin[x * w + (a >> 5)] >> (a & 31)) & 1u);
  }
  if (threadIdx.x == 0) {
    consistent_out[r] = consistent ? 1 : 0;
    k_out[r] = k;
  }
}

template <int KW>
cudaError_t launch(int rows, cudaStream_t stream, const void* cons, const void* mask,
                   const void* idx, const void* dom_in, const void* seed_in, void* dom_out,
                   void* consistent_out, void* k_out, int n, int d, int w) {
  return launch_rows(packed_fixpoint_kernel<KW>, rows, Smem(n, d, 4 * n * w).total, stream,
                     static_cast<const uint32_t*>(cons), static_cast<const uint8_t*>(mask),
                     static_cast<const int32_t*>(idx), static_cast<const uint32_t*>(dom_in),
                     static_cast<const uint8_t*>(seed_in), static_cast<uint8_t*>(dom_out),
                     static_cast<uint8_t*>(consistent_out), static_cast<int32_t*>(k_out), n, d,
                     w);
}

}  // namespace

// `sched`: kCompiledWidth (W = 1 and 2 as constants) or kRuntimeWidth.
extern "C" int packed_fixpoint_stacked_launch_sched(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, int w, int sched, void* stream) {
  if (rows <= 0) return 0;
  if (!width_sched(sched)) return static_cast<int>(cudaErrorInvalidValue);
  const int kw = sched == kCompiledWidth ? w : 0;
  const auto run = kw == 1 ? &launch<1> : kw == 2 ? &launch<2> : &launch<0>;
  return static_cast<int>(run(rows, static_cast<cudaStream_t>(stream), cons, mask, idx, dom_in,
                              seed_in, dom_out, consistent_out, k_out, n, d, w));
}

extern "C" int packed_fixpoint_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, int w, void* stream) {
  return packed_fixpoint_stacked_launch_sched(cons, mask, idx, dom_in, seed_in, dom_out,
                                              consistent_out, k_out, rows, n, d, w,
                                              kCompiledWidth, stream);
}
