// One stacked revise step, one CTA a row: the body of the packed and dense
// stacked revise kernels (packed_revise_stacked_launch in packed_revise.cu,
// dense_revise_stacked_launch in dense_revise.cu). Row r is revised against
// the slot table's network idx[r], read in place:
//
//   violated[r, x·d+a] = ∃y: seed[r,y] ∧ mask[idx[r],x,y] ∧
//                        no word of (net[x·d+a, y·K ..] & dom[r, y·K ..]) is nonzero
//
// for every value a, live or not, one byte per (x, a); an entry is K words
// of T (packed: W u32 words; dense: d/8 u64 words of the byte-per-bit
// table).
//
// What bounded the first design (a block per (row, 8 variables), a thread
// per (x·a, seeded y) pair): not bytes. Thread 0 of each of a row's n/8
// blocks listed the seed alone with n serial global loads; every pair paid
// a 32-bit division and a global mask load before the mask said whether it
// was constrained (6.5 % are at the main shape), and reloaded that mask byte
// for each of x's d values; and a frozen row, whose seed the stepped loop
// zeroes and which most rows are after two sweeps, cost as much as an
// active one.
//
// Design (with pieces of fixpoint_common.cuh): one CTA of 8 warps a row.
// - Seed bits: one 4-byte load a lane covers 128 flags, 8 lanes OR their
//   nibbles into a word. A row with no seed writes its n·d zero bytes with
//   16-byte stores and exits without reading its mask or its domain.
// - The row's domain goes to shared memory with the widest loads its
//   alignment allows.
// - Each variable x has an owner warp, x mod 8, and in it a lane. The lane
//   reads x's mask row, 8 flags a u64 load, and only the bytes in which the
//   seed has a bit (one load for a one-hot seed), and keeps x's seeded
//   neighbours as bits.
// - A scan over the lanes' counts places every (owned x, seeded neighbour y)
//   pair of the warp in one list, and the warp tests every (value a, pair)
//   at once, pairs fastest, several tests a lane in flight: no division and
//   no mask load per pair, and a light row (one seeded variable, about one
//   pair a warp at the main shape) costs one round of loads, not one a
//   variable.
// - Each owned x's d output bytes go out as 4-byte stores from its
//   violation bits (zeros for an x with no seeded neighbour).
//
// What bounds it now (measured on an H100, PERF.md): the memory system's
// rate for scattered sectors. A test reads one 8-byte (packed) or 40-byte
// (dense, two 32-byte sectors) entry of a row it shares with seldom-seeded
// neighbours, so a root row of the main shape reads 28K-56K sectors, and
// the root rows set the length of a launch that mixes them with light
// rows; the dense tables, several times L2, serve them from HBM. Designs
// measured and dropped: a group of lanes a dense entry, one 8-byte word a
// lane (slower on light rows and on a lone heavy row); 8 tests in flight
// for multi-word entries; values fastest; heavy rows split over 4 CTAs
// (faster for the dense 7:1 mix only, slower for light rows).
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
// 4), then per warp, u32: seed bits (ceil(n/32)), its owner lanes'
// seeded-neighbour bits (ceil(n/32) × owner_lanes, word-major, so the lanes
// store to distinct banks) and violation words (owner_lanes × ceil(d/32));
// u16: the (variable, neighbour) pairs of its owner lanes (owner_lanes × n).
// The pairs alone outgrow the shared memory for n ≥ 460, so a pair's
// neighbour always fits its 11 bits.
struct Smem {
  int seed, nbits, viol, pairs, total;
  __host__ __device__ Smem(int n, int d, int dom_bytes) {
    const int nwn = (n + 31) / 32, w = (d + 31) / 32, lanes = owner_lanes(n);
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
  const int nwn = (n + 31) / 32, w = (d + 31) / 32, nd = n * d, lanes = owner_lanes(n);
  const int dom_bytes = n * K * static_cast<int>(sizeof(T));
  const Smem L(n, d, dom_bytes);
  extern __shared__ __align__(16) uint8_t revise_smem[];  // not the .cu's own `smem`
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* dom = reinterpret_cast<T*>(revise_smem);
  uint32_t* seed = reinterpret_cast<uint32_t*>(revise_smem + L.seed) + warp * nwn;
  uint32_t* nbits = reinterpret_cast<uint32_t*>(revise_smem + L.nbits) + warp * lanes * nwn;
  uint32_t* viol = reinterpret_cast<uint32_t*>(revise_smem + L.viol) + warp * lanes * w;
  uint16_t* pairs = reinterpret_cast<uint16_t*>(revise_smem + L.pairs) + warp * lanes * n;

  const int r = blockIdx.x;
  const int slot_r = __ldg(idx + r);
  uint8_t* out = viol_out + static_cast<size_t>(r) * nd;
  // Every warp reads the same seed, so all agree and leave together.
  if (!row_seed_bits(seed_in + static_cast<size_t>(r) * n, seed, n, lane)) {
    zero_row(out, nd);
    return;
  }
  const size_t slot = static_cast<size_t>(slot_r);
  const T* net = cons + slot * static_cast<size_t>(nd) * n * K;
  const uint8_t* m = mask + slot * n * n;
  load_row(dom, dom_in + static_cast<size_t>(r) * n * K, dom_bytes);
  __syncthreads();

  for (int x0 = warp; x0 < n; x0 += 32 * kWarps) {  // this warp owns x ≡ warp mod 8
    const int x = x0 + lane * kWarps;  // one owned variable per lane
    const int c = x < n ? seeded_neighbours(m + static_cast<size_t>(x) * n, seed, n,
                                            nbits + lane, lanes) : 0;
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
    for (int l = 0; l < lanes && x0 + l * kWarps < n; ++l)
      store_flags(out + static_cast<size_t>(x0 + l * kWarps) * d, viol + l * w, d, lane);
    __syncwarp();  // nbits, pairs and viol are reused for the next 32 variables
  }
}

// Launch one CTA per row.
template <typename T, int KW>
int launch_stacked(const void* cons, const void* mask, const void* idx, const void* dom_in,
                   const void* seed_in, void* viol_out, int rows, int n, int d, int k,
                   void* stream) {
  if (rows <= 0) return 0;
  // a pair's neighbour has kPairY bits; word offsets into a network are 32-bit
  if (n >= (1 << kPairY) || static_cast<double>(n) * d * n * k >= 4294967296.0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fixpoint::launch_rows(
      revise_stacked_kernel<T, KW>, rows, Smem(n, d, n * k * static_cast<int>(sizeof(T))).total,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(cons),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(idx),
      static_cast<const T*>(dom_in), static_cast<const uint8_t*>(seed_in),
      static_cast<uint8_t*>(viol_out), n, d, k));
}

}  // namespace revise
