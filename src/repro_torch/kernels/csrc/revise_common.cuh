// One revise step, the body of all four revise kernels: the stacked ones
// (packed_revise_stacked_launch in packed_revise.cu, dense_revise_stacked_launch
// in dense_revise.cu), where row r is revised against the slot table's
// network idx[r], read in place, and the single-network ones
// (packed_revise_launch, dense_revise_launch), where every row is revised
// against ONE network:
//
//   violated[r, x·d+a] = ∃y: seed[r,y] ∧ mask[x,y] ∧
//                        no word of (net[x·d+a, y·K ..] & dom[r, y·K ..]) is nonzero
//
// for every value a, live or not, one byte per (x, a); an entry is K words
// of T (packed: W u32 words; dense: d/8 u64 words of the byte-per-bit
// table).
//
// What bounded the first design of both (a block per (row, 8 variables), a
// thread per (x·a, seeded y) pair): not bytes. Thread 0 of each of a row's
// n/8 blocks listed the seed alone with n serial global loads; every pair
// paid a 32-bit division and a global mask load before the mask said
// whether it was constrained (6.5 % are at the main shape), and reloaded
// that mask byte for each of x's d values; and a row with no seed, which
// most stepped rows are after two sweeps and a fifth of mac_solve's rows
// are, cost as much as an active one.
//
// Design (with pieces of fixpoint_common.cuh): CTAs of 8 warps.
// - Seed bits: one 4-byte load a lane covers 128 flags, 8 lanes OR their
//   nibbles into a word. A row with no seed writes its zero bytes with
//   16-byte stores and exits without reading its mask or its domain.
// - Each variable x has an owner warp and in it a lane. The lane reads x's
//   mask row, 8 flags a u64 load, and only the bytes in which the seed has a
//   bit (one load for a one-hot seed), and keeps x's seeded neighbours as
//   bits.
// - A scan over the lanes' counts places every (owned x, seeded neighbour y)
//   pair of the warp in one list, and the warp tests every (value a, pair)
//   at once, pairs fastest, several tests a lane in flight: no division and
//   no mask load per pair, and a light row (one seeded variable, about one
//   pair a warp at the main shape) costs one round of loads, not one a
//   variable.
// - Each owned x's d output bytes go out as 4-byte stores from its
//   violation bits (zeros for an x with no seeded neighbour).
//
// The stacked kernel: one CTA a row, x owned by warp x mod 8; the row's
// domain goes to shared memory with the widest loads its alignment allows.
// What bounds it (measured on an H100, PERF.md): the memory system's rate
// for scattered sectors. A test reads one 8-byte (packed) or 40-byte
// (dense, two 32-byte sectors) entry of a row it shares with
// seldom-seeded neighbours, so a root row of the main shape reads 28K-56K
// sectors, and the root rows set the length of a launch that mixes them
// with light rows; the dense tables, several times L2, serve them from
// HBM. Designs measured and dropped: a group of lanes a dense entry, one
// 8-byte word a lane (slower on light rows and on a lone heavy row); 8
// tests in flight for multi-word entries; values fastest; heavy rows split
// over 4 CTAs (faster for the dense 7:1 mix only, slower for light rows).
//
// The single-network kernel: `mac_solve` calls it once a recurrence with
// B = 1-64 rows (at the main shape 93 % of its launches have B = 2 or 4,
// about 10 seeds a seeded row), so one CTA a row leaves most of the card
// idle and runs a root row's ~28,000 tests on one SM. Here a row's
// variables are split over CTAs, a CTA per (row, span of variables), as
// many a row as give the card 4 CTAs an SM (`single_span`), down to one
// variable a warp. The network is compiled in as one (no slot map read).
// The CTA's mask rows are read whole, 8 flags a load, the first load issued
// before the seed's, and kept as bits; a test reads its domain entry from
// global memory beside the network entry (both L2 hits: the networks,
// 3.5 MB packed and 17.3 MB dense at the main shape, stay in the 50 MB L2).
// So a launch is three dependent rounds of loads (seed and mask, tests,
// stores), and no CTA stages the domain. What bounds it: latency, not
// bytes (measured on an H100, PERF.md): 5.4 µs (packed) and 7.0 µs (dense)
// a launch on the calls of one mac_solve, against a launch floor of 1.9 µs
// and byte bounds of 0.013 and 0.049 µs. Measured and dropped: one CTA a
// row (11.6 and 22.9 µs on those calls, 29 and 108 µs on the root call);
// 8 CTAs an SM (slower at B = 64, the same below); the mask groups the seed
// names, staged with cp.async after the seed (0.3-1.2 µs slower than plain
// loads); dense d/8 = 5 read at run time (a round of loads a word: 9.7
// against 7.9 µs).
//
// This kernel takes n below 2^kPairY = 2048 (a pair's neighbour has 11
// bits beside its lane). From there the single-network revises run
// block_revise.cuh's kernel on the network in this value-major layout
// (packed_revise_wide_launch, dense_revise_wide_launch): a group of 32 rows
// reads each constrained pair once. It replaced a variable a warp of this
// kernel, where every row re-read every entry it tested (measured on an
// H100 80GB HBM3 at 700 W, n=4096, d=32, `chip_smoke.py --against`, PERF.md:
// packed 32.80 -> 0.847 ms at B=512, 0.184 -> 0.171 at B=1; dense 102.9 ->
// 4.41 ms at B=512, 0.375 -> 0.208 at B=1). The sharded path's local
// revise, on an x-block in the reference's pair-major layout, is the same
// block kernel: this one, run there on a value-major x-block, took time in
// proportion to the rows.
#pragma once

#include "fixpoint_common.cuh"

namespace revise {

using fixpoint::kFull;
using fixpoint::kThreads;
using fixpoint::kWarps;
typedef unsigned long long u64;

// Lanes of a warp that own a variable: x = x0 + lane·kWarps < n.
__host__ __device__ inline int owner_lanes(int n) {
  const int lanes = (n + kWarps - 1) / kWarps;
  return lanes < 32 ? lanes : 32;
}

// Byte offsets into one CTA's dynamic shared memory; `total` is what
// launch.revise_smem computes. The row's domain (`dom_bytes`, a multiple of
// 4; the single-network kernel reads the domain in place and keeps its mask
// rows as bits there, `mbits_bytes`), then per
// warp, u32: seed bits (ceil(n/32)), its `lanes` owner lanes'
// seeded-neighbour bits (ceil(n/32) × lanes, word-major, so the lanes store
// to distinct banks) and violation words (lanes × ceil(d/32)); u16: the
// (variable, neighbour) pairs of its owner lanes (lanes × n). A CTA that
// owns every variable of a row has owner_lanes(n) lanes a warp; its pairs
// alone outgrow the shared memory for n ≥ 460. Both launchers refuse
// n ≥ 2^kPairY, so a pair's neighbour fits its 11 bits; from there the
// single-network revises run block_revise.cuh's kernel on the value-major
// network (packed_revise_wide_launch, dense_revise_wide_launch).
struct Smem {
  int seed, nbits, viol, pairs, total;
  __host__ __device__ Smem(int n, int d, int dom_bytes, int lanes) {
    const int nwn = (n + 31) / 32, w = (d + 31) / 32;
    seed = dom_bytes;
    nbits = seed + 4 * kWarps * nwn;
    viol = nbits + 4 * kWarps * lanes * nwn;
    pairs = viol + 4 * kWarps * lanes * w;
    total = pairs + 2 * kWarps * lanes * n;
  }
};

constexpr int kPairY = 11;  // bits of a pair's neighbour; the lane above them
constexpr int kUnrollRevise = 4;  // support tests a lane has in flight (8: one-word entries)

// Copy `bytes` (a multiple of 4) from global memory to `dst` (shared, 16-byte
// aligned), 16, 8 or 4 bytes a load as the source and size allow. All
// threads take part.
__device__ __forceinline__ void load_row(void* dst, const void* src, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes);
  if ((a & 15) == 0) {
    for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
      static_cast<uint4*>(dst)[i] = __ldg(static_cast<const uint4*>(src) + i);
  } else if ((a & 7) == 0) {
    for (int i = threadIdx.x; i < bytes / 8; i += kThreads)
      static_cast<uint2*>(dst)[i] = __ldg(static_cast<const uint2*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < bytes / 4; i += kThreads)
      static_cast<uint32_t*>(dst)[i] = __ldg(static_cast<const uint32_t*>(src) + i);
  }
}

// Zero `bytes` bytes at `dst` (global), 16 bytes a store between an
// unaligned head and tail. All threads take part.
__device__ __forceinline__ void zero_row(uint8_t* dst, int bytes) {
  const int misaligned = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(bytes, (16 - misaligned) & 15);
  const int body = (bytes - head) / 16;
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = 0;
  uint4* mid = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads) mid[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = head + 16 * body + threadIdx.x; i < bytes; i += kThreads) dst[i] = 0;
}

// The row's seed (n flags at `row`) as bits in the warp's `seed`; returns
// whether any is set (warp-uniform). With n a multiple of 4 and `row`
// 4-byte aligned, one 4-byte load a lane covers 128 flags, and 8 lanes OR
// their nibbles into a word; otherwise fixpoint::seed_bits' ballots, one a
// 32 flags.
__device__ __forceinline__ bool row_seed_bits(const uint8_t* row, uint32_t* seed, int n,
                                              int lane) {
  if ((n & 3) != 0 || (reinterpret_cast<uintptr_t>(row) & 3) != 0)
    return fixpoint::seed_bits(row, seed, n, lane);
  uint32_t any = 0;
  for (int y0 = 0; y0 < n; y0 += 128) {
    const int y = y0 + 4 * lane;
    const uint32_t v = y < n ? __ldg(reinterpret_cast<const uint32_t*>(row + y)) : 0u;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) word |= static_cast<uint32_t>(((v >> (8 * b)) & 0xffu) != 0) << b;
    word <<= 4 * (lane & 7);  // y's bit in word (y0 + 4·lane) / 32
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    word |= __shfl_xor_sync(kFull, word, 4);
    const int j = y0 / 32 + (lane >> 3);
    if ((lane & 7) == 0 && 32 * j < n) seed[j] = word;
    any |= word;
  }
  __syncwarp();
  return __any_sync(kFull, any != 0);
}

// One lane: the seeded neighbours of its variable, whose mask row is `mrow`
// (n flags), as bits — word j goes to bits[stride * j]. Reads only the 8-flag
// groups in which the warp's `seed` bits have one set, one aligned 8-byte
// load a group when n is a multiple of 8. Returns how many there are.
__device__ __forceinline__ int seeded_neighbours(const uint8_t* __restrict__ mrow,
                                                 const uint32_t* seed, int n, uint32_t* bits,
                                                 int stride) {
  const int nwn = (n + 31) / 32;
  const bool wide = (n & 7) == 0 && (reinterpret_cast<uintptr_t>(mrow) & 7) == 0;
  int count = 0;
  for (int j = 0; j < nwn; ++j) {
    const uint32_t s = seed[j];  // the same for every lane: no divergence below
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t sb = (s >> (8 * q)) & 0xffu;
      if (sb == 0) continue;  // seed bits are set only for y < n
      const int y0 = 32 * j + 8 * q;
      uint32_t f = 0;
      if (wide) {
        const u64 v = __ldg(reinterpret_cast<const u64*>(mrow + y0));
#pragma unroll
        for (int b = 0; b < 8; ++b)
          f |= static_cast<uint32_t>(((v >> (8 * b)) & 0xffu) != 0) << b;
      } else {
        for (int b = 0; b < 8 && y0 + b < n; ++b)
          f |= static_cast<uint32_t>(__ldg(mrow + y0 + b) != 0) << b;
      }
      word |= (f & sb) << (8 * q);
    }
    bits[stride * j] = word;
    count += __popc(word);
  }
  return count;
}

// One lane: the seeded neighbours of its variable from its mask row as bits
// (`mrow`, ceil(n/32) words in shared memory) and the warp's `seed` bits —
// word j goes to bits[stride * j]. Returns how many there are.
__device__ __forceinline__ int masked_neighbours(const uint32_t* mrow, const uint32_t* seed,
                                                 int nwn, uint32_t* bits, int stride) {
  int count = 0;
  for (int j = 0; j < nwn; ++j) {
    const uint32_t word = mrow[j] & seed[j];
    bits[stride * j] = word;
    count += __popc(word);
  }
  return count;
}

// The support tests of a warp's owned variables, all at once: every (value
// a < d, pair p) of the np `pairs` — (lane l << kPairY) | y, variable
// x0 + l·kWarps against its seeded neighbour y — pairs fastest, so lanes
// that share a value read entries of one network row, and with few pairs
// the lanes run over values. An entry is K words of T at
// net[(x·d + a)·n·K + y·K ..]; a is supported by y iff some word ANDs
// nonzero with dom[y·K ..]. An unsupported a sets bit a of viol[l·w ..],
// lane l's violation words. The failing lanes of a step mostly share one
// word (a one-hot seed fails many values of one variable; a padded value
// fails every test), and 32 atomics on one word run one after another, so
// those lanes OR their bits together and one of them stores them. Each lane
// keeps U tests, K·U loads, in flight: U = 2·kUnrollRevise for one-word
// entries, kUnrollRevise otherwise; offsets are 32-bit to save registers.
// KW = 0 reads K at run time.
template <typename T, int KW>
__device__ __forceinline__ void test_pairs(const T* __restrict__ net, const T* dom, int x0,
                                           int n, int d, int k_words, const uint16_t* pairs,
                                           int np, uint32_t* viol, int w, int lane) {
  constexpr int U = KW == 1 ? 2 * kUnrollRevise : kUnrollRevise;
  const int K = KW > 0 ? KW : k_words;
  const uint32_t row_stride = static_cast<uint32_t>(n * K);
  const int q = 32 / np, rem = 32 % np;  // a step of 32 tests, without a division
  int a = lane / np, pi = lane - a * np;
  for (int base = 0; base < d * np; base += 32 * U) {
    uint32_t src[U], dy[U];  // word offsets into net and dom
    int key[U];              // (violation word << 5) | bit of the test's value, or -1
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = a < d;
      const int e = ok ? pairs[pi] : 0;
      const int y = e & ((1 << kPairY) - 1), l = e >> kPairY;
      dy[u] = static_cast<uint32_t>(y * K);
      src[u] = static_cast<uint32_t>((x0 + l * kWarps) * d + a) * row_stride + dy[u];
      key[u] = ok ? ((l * w + (a >> 5)) << 5) | (a & 31) : -1;
      a += q;
      pi += rem;
      if (pi >= np) {
        pi -= np;
        ++a;
      }
    }
    T sup[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sup[u] = 0;
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (key[u] >= 0) sup[u] |= __ldg(net + src[u] + j) & dom[dy[u] + j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every lane runs the warp intrinsics below
      const bool fail = key[u] >= 0 && sup[u] == 0;
      const uint32_t fails = __ballot_sync(kFull, fail);
      if (fails) {  // one atomic for the failing lanes that share the first one's word
        const int first = __ffs(fails) - 1;
        const int word = key[u] >> 5, lead = __shfl_sync(kFull, word, first);
        const bool joined = fail && word == lead;
        const uint32_t bits = __reduce_or_sync(kFull, joined ? 1u << (key[u] & 31) : 0u);
        if (lane == first) atomicOr(&viol[lead], bits);
        if (fail && !joined) atomicOr(&viol[word], 1u << (key[u] & 31));
      }
    }
  }
}

// x's d output bytes from its violation words: byte a = bit a. Four bytes a
// store when d is a multiple of 4 and `out` 4-byte aligned.
__device__ __forceinline__ void store_flags(uint8_t* out, const uint32_t* viol, int d, int lane) {
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    for (int j = lane; 4 * j < d; j += 32) {
      const uint32_t nib = (viol[j >> 3] >> (4 * (j & 7))) & 0xfu;  // values 4j .. 4j+3
      reinterpret_cast<uint32_t*>(out)[j] =
          (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) | ((nib & 8u) << 21);
    }
  } else {
    for (int a = lane; a < d; a += 32)
      out[a] = static_cast<uint8_t>((viol[a >> 5] >> (a & 31)) & 1u);
  }
}

// The revise of one row's variables [x_begin, x_end) against network `net`
// (mask rows `m`), the row's domain at `dom` (shared or global memory) and
// its seed bits in the warp's `seed`: warp `warp` owns x ≡ x_begin + warp
// (mod 8), one variable a lane, 32·8 variables a pass. The warp's `lanes`
// owner lanes keep their seeded-neighbour bits in `nbits`, their violation
// words in `viol` and the warp's pairs in `pairs`. With `mbits` (the mask
// rows of [x_begin, x_end) as bits, ceil(n/32) words a row, in shared
// memory) the neighbours come from there; without, from `m`. Network rows,
// mask rows and `out` are indexed by x; `n` counts the neighbours y.
template <typename T, int KW>
__device__ __forceinline__ void revise_vars(const T* __restrict__ net,
                                            const uint8_t* __restrict__ m,
                                            const uint32_t* mbits, const T* dom,
                                            const uint32_t* seed, uint32_t* nbits,
                                            uint32_t* viol, uint16_t* pairs, uint8_t* out,
                                            int x_begin, int x_end, int n, int d, int K,
                                            int lanes, int warp, int lane) {
  const int w = (d + 31) / 32, nwn = (n + 31) / 32;
  for (int x0 = x_begin + warp; x0 < x_end; x0 += 32 * kWarps) {
    const int x = x0 + lane * kWarps;  // one owned variable per lane
    int c = 0;
    if (x < x_end)
      c = mbits ? masked_neighbours(mbits + (x - x_begin) * nwn, seed, nwn, nbits + lane, lanes)
                : seeded_neighbours(m + static_cast<size_t>(x) * n, seed, n, nbits + lane, lanes);
    int end = c;  // this lane's pairs go to [end - c, end)
    for (int s = 1; s < 32; s <<= 1) {
      const int t = __shfl_up_sync(kFull, end, s);
      if (lane >= s) end += t;
    }
    const int np = __shfl_sync(kFull, end, 31);
    for (int j = 0, k = end - c; k < end; ++j)
      for (uint32_t bits = nbits[lanes * j + lane]; bits; bits &= bits - 1)
        pairs[k++] = static_cast<uint16_t>((lane << kPairY) | (32 * j + __ffs(bits) - 1));
    for (int i = lane; i < lanes * w; i += 32) viol[i] = 0u;
    __syncwarp();
    if (np) test_pairs<T, KW>(net, dom, x0, n, d, K, pairs, np, viol, w, lane);
    __syncwarp();
    for (int l = 0; l < lanes && x0 + l * kWarps < x_end; ++l)
      store_flags(out + static_cast<size_t>(x0 + l * kWarps) * d, viol + l * w, d, lane);
    __syncwarp();  // nbits, pairs and viol are reused for the next 32 variables
  }
}

// The per-warp regions of `L` in this CTA's dynamic shared memory.
struct WarpSmem {
  uint32_t *seed, *nbits, *viol;
  uint16_t* pairs;
  __device__ WarpSmem(uint8_t* base, const Smem& L, int n, int d, int lanes, int warp) {
    const int nwn = (n + 31) / 32, w = (d + 31) / 32;
    seed = reinterpret_cast<uint32_t*>(base + L.seed) + warp * nwn;
    nbits = reinterpret_cast<uint32_t*>(base + L.nbits) + warp * lanes * nwn;
    viol = reinterpret_cast<uint32_t*>(base + L.viol) + warp * lanes * w;
    pairs = reinterpret_cast<uint16_t*>(base + L.pairs) + warp * lanes * n;
  }
};

template <typename T, int KW>  // KW: words per entry, or 0: k_arg at run time
__global__ void __launch_bounds__(kThreads) revise_stacked_kernel(
    const T* __restrict__ cons,           // (C, n*d, n*K) slot table
    const uint8_t* __restrict__ mask,     // (C, n, n)
    const int32_t* __restrict__ idx,      // (R,) row -> table slot
    const T* __restrict__ dom_in,         // (R, n*K) domains
    const uint8_t* __restrict__ seed_in,  // (R, n) revision seed
    uint8_t* __restrict__ viol_out,       // (R, n*d)
    int n, int d, int k_arg) {
  const int K = KW > 0 ? KW : k_arg;
  const int nd = n * d, lanes = owner_lanes(n);
  const int dom_bytes = n * K * static_cast<int>(sizeof(T));
  const Smem L(n, d, dom_bytes, lanes);
  extern __shared__ __align__(16) uint8_t revise_smem[];  // not the .cu's own `smem`
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* dom = reinterpret_cast<T*>(revise_smem);
  const WarpSmem S(revise_smem, L, n, d, lanes, warp);

  const int r = blockIdx.x;
  const int slot_r = __ldg(idx + r);
  uint8_t* out = viol_out + static_cast<size_t>(r) * nd;
  // Every warp reads the same seed, so all agree and leave together.
  if (!row_seed_bits(seed_in + static_cast<size_t>(r) * n, S.seed, n, lane)) {
    zero_row(out, nd);
    return;
  }
  const size_t slot = static_cast<size_t>(slot_r);
  load_row(dom, dom_in + static_cast<size_t>(r) * n * K, dom_bytes);
  __syncthreads();
  revise_vars<T, KW>(cons + slot * static_cast<size_t>(nd) * n * K, mask + slot * n * n,
                     nullptr, dom, S.seed, S.nbits, S.viol, S.pairs, out, 0, n, n, d, K, lanes,
                     warp, lane);
}

// Bytes of a single-network CTA's mask bits (in the layout's domain place):
// ceil(n/32) words for each variable of its span.
__host__ __device__ inline int mbits_bytes(int n, int span) { return 4 * ((n + 31) / 32) * span; }

// B rows against one network: CTA (r, s) revises row r's variables
// [s·span, (s+1)·span); span is a multiple of 8. The network may be an
// x-block: its nx rows of variables (network and mask rows, outputs) against
// all n neighbours (seed and domain); nx = n is the whole network. The CTA's
// mask rows go to shared memory as bits, each 8 flags one load, and a
// thread's first load is issued before the seed's, so the two take one
// round together.
template <typename T, int KW>  // KW: words per entry, or 0: k_arg at run time
__global__ void __launch_bounds__(kThreads) revise_single_kernel(
    const T* __restrict__ net,            // (nx*d, n*K) the network's x-block
    const uint8_t* __restrict__ mask,     // (nx, n)
    const T* __restrict__ dom_in,         // (B, n*K) domains
    const uint8_t* __restrict__ seed_in,  // (B, n) revision seed
    uint8_t* __restrict__ viol_out,       // (B, nx*d)
    int nx, int n, int d, int k_arg, int span) {
  const int K = KW > 0 ? KW : k_arg;
  const int lanes = owner_lanes(span);
  const Smem L(n, d, mbits_bytes(n, span), lanes);
  extern __shared__ __align__(16) uint8_t revise_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const WarpSmem S(revise_smem, L, n, d, lanes, warp);
  uint8_t* mbits = revise_smem;  // row v - x_begin: 4·ceil(n/32) bytes, flags of y = 8b.. in byte b

  const int r = blockIdx.x;
  const int x_begin = blockIdx.y * span, x_end = min(nx, x_begin + span);
  const int groups = (n + 7) / 8, nb = 4 * ((n + 31) / 32);
  const int items = (x_end - x_begin) * groups;  // (variable, 8-flag group) pairs
  // with n a multiple of 8 the span's mask rows are items aligned u64 words
  const bool wide = (n & 7) == 0 && (reinterpret_cast<uintptr_t>(mask) & 7) == 0;
  const uint8_t* mrows = mask + static_cast<size_t>(x_begin) * n;
  const u64* mwords = reinterpret_cast<const u64*>(mrows);
  const u64 first = wide && tid < items ? __ldg(mwords + tid) : 0ull;
  uint8_t* out = viol_out + static_cast<size_t>(r) * nx * d;
  if (!row_seed_bits(seed_in + static_cast<size_t>(r) * n, S.seed, n, lane)) {
    zero_row(out + static_cast<size_t>(x_begin) * d, (x_end - x_begin) * d);
    return;
  }
  for (int i = tid; i < items; i += kThreads) {
    const int v = i / groups, b = i - v * groups;
    uint32_t f = 0;
    if (wide) {
      const u64 word = i < kThreads ? first : __ldg(mwords + i);
#pragma unroll
      for (int q = 0; q < 8; ++q) f |= static_cast<uint32_t>(((word >> (8 * q)) & 0xffu) != 0) << q;
    } else {
      for (int q = 0; q < 8 && 8 * b + q < n; ++q)
        f |= static_cast<uint32_t>(__ldg(mrows + v * n + 8 * b + q) != 0) << q;
    }
    mbits[v * nb + b] = static_cast<uint8_t>(f);  // bytes past `groups` are never written:
  }                                               // the seed's bits there are 0
  __syncthreads();
  revise_vars<T, KW>(net, mask, reinterpret_cast<const uint32_t*>(mbits),
                     dom_in + static_cast<size_t>(r) * n * K, S.seed, S.nbits, S.viol, S.pairs,
                     out, x_begin, x_end, n, d, K, lanes, warp, lane);
}

// Whether the kernels take (n, d, K): a pair's neighbour has kPairY bits,
// and word offsets into a network are 32-bit.
inline bool takes(int n, int d, int k) {
  return n < (1 << kPairY) && static_cast<double>(n) * d * n * k < 4294967296.0;
}

// Launch one CTA per row.
template <typename T, int KW>
int launch_stacked(const void* cons, const void* mask, const void* idx, const void* dom_in,
                   const void* seed_in, void* viol_out, int rows, int n, int d, int k,
                   void* stream) {
  if (rows <= 0) return 0;
  if (!takes(n, d, k)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fixpoint::launch_rows(
      revise_stacked_kernel<T, KW>, rows,
      Smem(n, d, n * k * static_cast<int>(sizeof(T)), owner_lanes(n)).total,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(cons),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(idx),
      static_cast<const T*>(dom_in), static_cast<const uint8_t*>(seed_in),
      static_cast<uint8_t*>(viol_out), n, d, k));
}

constexpr int kCtasPerSm = 4;  // single-network CTAs a launch aims to give each SM

// Variables a single-network CTA revises (a multiple of 8) by default: the
// fewest that still give the card kCtasPerSm CTAs an SM over `rows` rows,
// and at least one a warp, so B = 1-40 rows at n = 104 run 13 CTAs a row.
// kernels/autotune.py mirrors this rule and may tune another span per
// shape bucket.
inline int single_span(int rows, int n) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const int blocks = (n + kWarps - 1) / kWarps;  // groups of 8 variables
  const int want = (kCtasPerSm * sms + rows - 1) / rows;
  const int groups = want < 1 ? 1 : (want < blocks ? want : blocks);
  return kWarps * ((blocks + groups - 1) / groups);
}

// Launch rows × ceil(n / span) CTAs against one network. `span` is a tuned
// schedule (kernels/autotune.py): a multiple of 8, at most n rounded up to
// 8; 0 takes `single_span`'s rule. Refuses n ≥ 2^kPairY: there the
// single-network revises run block_revise.cuh's kernel.
template <typename T, int KW>
int launch_single(const void* net, const void* mask, const void* dom_in, const void* seed_in,
                  void* viol_out, int rows, int n, int d, int k, int span, void* stream) {
  if (rows <= 0) return 0;
  if (!takes(n, d, k) || span < 0 || span % kWarps != 0 || span > kWarps * ((n + 7) / 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (span == 0) span = single_span(rows, n);
  return static_cast<int>(fixpoint::launch_rows(
      revise_single_kernel<T, KW>, dim3(rows, (n + span - 1) / span),
      Smem(n, d, mbits_bytes(n, span), owner_lanes(span)).total,
      static_cast<cudaStream_t>(stream),
      static_cast<const T*>(net), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(dom_in), static_cast<const uint8_t*>(seed_in),
      static_cast<uint8_t*>(viol_out), n, n, d, k, span));
}

}  // namespace revise
