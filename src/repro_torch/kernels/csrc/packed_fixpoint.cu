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
// - One CTA per row, unless a launch's rows leave most SMs idle. Then each
//   row is split over a thread-block cluster of c CTAs that share its
//   variables (SPLIT below), so a few heavy rows keep more sectors in
//   flight. The launcher's rule (launch.fixpoint_split): c is the largest
//   power of two up to min(8, 2 · SMs / rows) (two split CTAs fit an SM)
//   where n >= launch.SPLIT_MIN_N (256), else 1, and 1 where the card holds
//   no such cluster (cudaOccupancyMaxActiveClusters). Many light rows fill
//   the card alone, and there a cluster only adds its barriers and copies:
//   1,024 rows at n = 104 ran 2-4.5 times slower split (PERF.md).
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

// KW: words per entry (W), or 0: read w at run time. SPLIT: the row's
// variables are split over the CTAs of a thread-block cluster (KW = 0 only):
// CTA q of c owns the span of split_span(n, c) variables from q · span, holds
// only their mask rows, and keeps whole copies of both domain buffers and
// changed flags. Each sweep it revises its span against its CURRENT copy
// into its NEXT; after a cluster barrier it copies each peer's span of NEXT
// and of the changed flags from the peer's shared memory in 16-byte pieces
// and ORs the peers' wipe-out flags, and a CTA barrier ends the sweep. So
// every CTA enters each sweep with the same domains, and the sweep is the
// unsplit one. One cluster barrier a sweep is enough: a peer writes its span
// of a buffer again only two sweeps on, after the next cluster barrier,
// which every CTA reaches only once its copy of that span is done; a last
// cluster barrier keeps each CTA's shared memory until its peers are done.
template <int KW, bool SPLIT>
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
  int c = 1, rank = 0;  // the row's CTAs, and this one's rank among them
  if constexpr (SPLIT) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    c = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int span = SPLIT ? split_span(n, c) : n;
  const int base = SPLIT ? rank * span : 0;  // this CTA owns x in [base, end)
  const int end = SPLIT ? min(n, base + span) : n;
  const Smem L(n, d, 4 * nw, c);
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* const dom0 = reinterpret_cast<uint32_t*>(smem);  // the two domain buffers
  const int held = SPLIT ? c * span : n;  // variables a buffer holds
  uint32_t* const dom1 = dom0 + (SPLIT ? held * w : nw);
  const uint32_t* mbits = reinterpret_cast<const uint32_t*>(smem + L.mbits);  // rows base..end
  uint32_t* seed = reinterpret_cast<uint32_t*>(smem + L.seed) + warp * nwn;
  uint32_t* viol = reinterpret_cast<uint32_t*>(smem + L.viol) + warp * w;
  uint32_t* dead = reinterpret_cast<uint32_t*>(smem + L.dead);  // [2], written like next
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem + L.ys) + warp * n;
  uint16_t* values = reinterpret_cast<uint16_t*>(smem + L.values) + warp * d;
  uint8_t* const changed0 = smem + L.changed;  // and the two buffers of changed flags
  uint8_t* const changed1 = changed0 + held;

  const int r = SPLIT ? blockIdx.x / c : blockIdx.x;
  const size_t slot = static_cast<size_t>(idx[r]);
  const uint32_t* net = cons + slot * static_cast<size_t>(n * d) * nw;

  for (int i = threadIdx.x; i < nw; i += kThreads)
    dom0[i] = dom_in[static_cast<size_t>(r) * nw + i];
  for (int x = threadIdx.x; x < n; x += kThreads)
    changed0[x] = seed_in[static_cast<size_t>(r) * n + x] != 0;
  if (threadIdx.x < 2) dead[threadIdx.x] = 0u;
  if constexpr (SPLIT)
    load_mask_rows(mask + (slot * n + base) * n, smem + L.mbits, n, end - base);
  else
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
    for (int x0 = base + warp; x0 < end; x0 += 32 * kWarps) {  // this warp owns x ≡ warp mod 8
      const int x = x0 + lane * kWarps;  // one owned variable per lane
      const bool hit = x < end && constrained(mbits + (x - base) * nwn, seed, nwn);
      if (x < end && !hit) {  // no seeded neighbour: x keeps its domain
        for (int j = 0; j < w; ++j) next[x * w + j] = cur[x * w + j];
        next_changed[x] = 0;
      }
      for (uint32_t todo = __ballot_sync(kFull, hit); todo; todo &= todo - 1) {
        const int xv = x0 + (__ffs(todo) - 1) * kWarps;  // the whole warp revises xv
        const uint32_t* words = cur + xv * w;
        const int nv = packed_values(words, d, w, values, lane);
        const int m = neighbours(mbits + (xv - base) * nwn, seed, nwn, ys, lane);
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
    if constexpr (SPLIT) {
      cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
      cluster.sync();  // every CTA's span of next, its flags and its wipe-out are written
      const int words16 = span * w / 4, per = words16 + span / 16;  // 16-byte pieces a span
      for (int i = threadIdx.x; i < (c - 1) * per; i += kThreads) {
        const int q = (rank + 1 + i / per) % c, j = i % per;
        uint4* const piece =
            j < words16 ? reinterpret_cast<uint4*>(next + q * span * w) + j
                        : reinterpret_cast<uint4*>(next_changed + q * span) + (j - words16);
        *piece = *cluster.map_shared_rank(piece, q);
      }
      const bool wiped = threadIdx.x < c &&
                         *cluster.map_shared_rank(dead + (p ^ 1), threadIdx.x) != 0u;
      consistent = !__syncthreads_or(wiped);
    } else {
      __syncthreads();
      consistent = dead[p ^ 1] == 0u;
    }
    p ^= 1;
    ++k;
  }

  const uint32_t* fin = p ? dom1 : dom0;
  for (int i = threadIdx.x; i < (end - base) * d; i += kThreads) {
    const int x = i / d, a = i - x * d;
    dom_out[(static_cast<size_t>(r) * n + base) * d + i] =
        static_cast<uint8_t>((fin[(base + x) * w + (a >> 5)] >> (a & 31)) & 1u);
  }
  if (threadIdx.x == 0 && rank == 0) {
    consistent_out[r] = consistent ? 1 : 0;
    k_out[r] = k;
  }
  if constexpr (SPLIT) cooperative_groups::this_cluster().sync();  // peers may still read
}

template <int KW>
cudaError_t launch(int rows, cudaStream_t stream, const void* cons, const void* mask,
                   const void* idx, const void* dom_in, const void* seed_in, void* dom_out,
                   void* consistent_out, void* k_out, int n, int d, int w) {
  return launch_rows(packed_fixpoint_kernel<KW, false>, rows, Smem(n, d, 4 * n * w).total, stream,
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

// Kernel 1 with each row split over a cluster of c CTAs, 2 <= c <= kMaxSplit
// (launch.fixpoint_split picks c); W read at run time.
extern "C" int packed_fixpoint_split_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, int w, int c, void* stream) {
  if (rows <= 0) return 0;
  if (c < 2 || c > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      packed_fixpoint_kernel<0, true>, rows, c, Smem(n, d, 4 * n * w, c).total,
      static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(cons),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(idx),
      static_cast<const uint32_t*>(dom_in), static_cast<const uint8_t*>(seed_in),
      static_cast<uint8_t*>(dom_out), static_cast<uint8_t*>(consistent_out),
      static_cast<int32_t*>(k_out), n, d, w));
}

// How many clusters of `packed_fixpoint_split_launch` at (n, d, w, c) the
// card holds at once, into *(int*)clusters (0: none fits).
extern "C" int packed_fixpoint_split_clusters(void* clusters, int n, int d, int w, int c,
                                              void* stream) {
  if (c < 2 || c > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(max_clusters(packed_fixpoint_kernel<0, true>, c,
                                       Smem(n, d, 4 * n * w, c).total,
                                       static_cast<cudaStream_t>(stream),
                                       static_cast<int*>(clusters)));
}
