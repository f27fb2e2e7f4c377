// The block revise: B domains against an x-block of ONE network, the rows
// of nx variables against all n neighbours, in one of two layouts:
// - pair-major (the sharded path's local revise; the reference's block,
//   src/repro/core/sharded.py `cons_blk_pk (nx, n, d, W)`): entry (x, y, a)
//   at ((x·n + y)·d + a)·K, the d entries of one (x, y) pair contiguous;
// - value-major (kValueMajor; the single-network revises from n = 2048 on
//   the whole network, nx = n, the reference's single-network operand
//   `cons (n·d, n·K)`): entry (x, y, a) at ((x·d + a)·n + y)·K.
//
//   violated[r, x, a] = ∃y: seed[r,y] ∧ mask[x,y] ∧
//                       no word of (net[x, y, a, ..] & dom[r, y, ..]) is nonzero
//
// for every value a, live or not, one byte per (r, x, a). An entry is K
// words of T: packed, W u32 words (W = 2 as one u64); dense u8, d/8 u64
// words of the byte-per-bit table.
//
// Replaces two TPU kernels: `packed_revise`
// (src/repro/kernels/bitpack_support.py:64) for the bitpacked local revise
// (`_local_revise_bitpacked`) and, from n = 2048, for the single-network
// path (packed_revise_wide_launch); and `dense_revise` (rtac_support.py:71)
// for the dense u8 local revise and, from n = 2048, the single-network
// path (dense_revise_wide_launch). Included by packed_revise.cu and
// dense_revise.cu.
//
// The block route used to be the single-network kernel (revise_common.cuh)
// on an x-block in a value-major layout (nx·d, n·K): a CTA per (row, span of
// variables), so every row re-read every entry it tested, one 4-byte word
// of a 32-byte sector of its own a test (about 172M tests at n=4096, d=32,
// B=32). Measured on an H100 (PERF.md): its time grew in proportion to the
// rows. Design here:
// - Two launches. A first pass turns the seeds into bits once: for each
//   group of 32 rows, a word a neighbour y (bit r: row r seeds y) and the
//   group's union as n bits; and it transposes the group's domains so that
//   the 32 rows' words for one y are contiguous.
// - A CTA owns a span of variables and a group of up to 32 rows. Each
//   variable's mask row is read once, as 32 flags a lane, and ANDed with
//   the union: only (x, seeded y) pairs are listed, a window of 1024
//   neighbours at a time in a warp's shared list (2 KB a warp, whatever n).
// - Each listed pair's d entries are read once, lane = value a, and tested
//   against every row of the group that seeds y: pair-major one coalesced
//   load (128 B for packed d=32), value-major one sector a value (32 B of
//   which packed uses 4, dense d=32 all). The rows' domain words at y come
//   in one coalesced load (lane = row). Where more than a few rows seed y,
//   the lanes put them in a per-warp stage in shared memory and every lane
//   reads them back 16 bytes at a time (broadcast reads); else they go
//   round by shuffles, one a seeding row.
// - Violations gather as a row mask a lane (bit r: row r, value a); at the
//   end of a variable, 32 ballots turn them into one word a row, and each
//   lane writes its row's d bytes.
// - Where the span's variables give too few CTAs for the card, a span is
//   1, 2 or 4 variables and a variable's neighbour words are split over
//   8, 4 or 2 warps, whose row masks meet in shared memory.
// - Value-major, the row groups are the grid's fastest dimension: the
//   groups of one span run side by side and meet in L2 on the sectors they
//   share. Pair-major, the spans are.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W, PERF.md):
// pair-major at the production shape (n=4096, d=32, B=32, every variable
// seeded) a call takes 0.066 ms against the old route's 2.04 and a byte
// bound of 0.013. Half of that is the tests themselves, about 4
// instructions a (pair, row): the same call with the tests cut out takes
// 0.035 ms. Value-major on the whole network at B=512 (x6's first call):
// packed 0.847 ms (the pair-major call on the same operands is in
// PERF.md: a pair's values lie in 32 sectors here, in one 128-byte line
// there), dense 4.41 ms (an entry is one sector either way); at B = 1, 5,
// 64 packed 0.171, 0.172, 0.202 ms: one group reads every pair's sectors
// alone. Measured and dropped: shuffles for every seeding row instead of
// the stage (0.152 ms; the transposed domain alone gains nothing without
// the stage); spans for 2 or 8 CTAs an SM instead of 4 (within 2 % at the
// driven shapes); value-major with the row groups slowest in the grid
// (packed 2.648 ms at B=512, 3.13× slower; 0.346 at B=64; dense 1.05×
// slower).
#pragma once

#include "fixpoint_common.cuh"

namespace block {

using fixpoint::kFull;
using fixpoint::kThreads;
using fixpoint::kWarps;
typedef unsigned long long u64;

constexpr int kGroup = 32;      // rows a CTA revises together: the bits of a row mask
constexpr int kWindow = 1024;   // neighbours a warp lists at once: 32 flags a lane
constexpr int kMaxN = 65535;    // a listed neighbour is a u16
constexpr int kCtasPerSm = 4;   // CTAs a launch aims to give each SM
constexpr int kStageBytes = 2048;  // a warp's stage: U pairs' rows' domain words
constexpr int kFewRows = 4;     // seeding rows a pair tests by shuffles, not the stage

// Byte offsets into one CTA's dynamic shared memory; `total` is what
// kernels/launch.py's `block_smem` computes: the group's union bits
// (ceil(n/32) u32), per warp a list of kWindow u16 neighbours, per warp a
// row-mask slot of 32 u32 (one a value of a chunk of 32), per warp a stage
// of kStageBytes (16-byte aligned).
struct Smem {
  int list, slots, stage, total;
  __host__ __device__ explicit Smem(int n) {
    list = 4 * ((n + 31) / 32);
    slots = list + 2 * kWarps * kWindow;
    stage = (slots + 4 * kWarps * 32 + 15) / 16 * 16;
    total = stage + kWarps * kStageBytes;
  }
};

// Byte offsets into the seed pass's output for `rows` rows, `entry` bytes a
// (row, variable) domain: per group of 32 rows n row masks (u32), then the
// groups' ceil(n/32) union words, then (16-byte aligned) the transposed
// domains, 32 rows' entries a variable a group.
struct Scratch {
  size_t any, dom_t, total;
  __host__ __device__ Scratch(int rows, int n, int entry) {
    const size_t groups = (rows + kGroup - 1) / kGroup;
    any = 4 * groups * n;
    dom_t = (any + 4 * groups * ((n + 31) / 32) + 15) / 16 * 16;
    total = dom_t + groups * n * kGroup * entry;
  }
};

// The first pass, a CTA per (32 variables from y0, group g of 32 rows).
// Each warp ballots the group's seed flags of 4 of the variables (lane =
// row) into row_bits[g·n + y] (bit r: row 32g + r seeds y); warp 0 ballots
// the 32 words into the union word any_bits[g·ceil(n/32) + y0/32]. Then, a
// word k of each entry at a time, the CTA reads the 32 rows' domain words
// of its variables (lane = variable, coalesced) into a tile and writes them
// transposed, dom_t[((g·n + y)·32 + r)·K + k] (lane = row, coalesced); the
// missing rows of a last group are zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) seed_pass_kernel(
    const uint8_t* __restrict__ seed, const T* __restrict__ dom, uint32_t* __restrict__ row_bits,
    uint32_t* __restrict__ any_bits, T* __restrict__ dom_t, int rows, int n, int K) {
  __shared__ T tile[kGroup][33];
  __shared__ uint32_t words[32];
  const int g = blockIdx.y, y0 = 32 * blockIdx.x, r0 = g * kGroup, rg = min(kGroup, rows - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < 32; i += kWarps) {
    const int y = y0 + i;
    const bool seeded = y < n && lane < rg &&
                        __ldg(seed + static_cast<size_t>(r0 + lane) * n + y) != 0;
    const uint32_t word = __ballot_sync(kFull, seeded);
    if (lane == 0) {
      words[i] = word;
      if (y < n) row_bits[static_cast<size_t>(g) * n + y] = word;
    }
  }
  const int y = y0 + lane;
  for (int k = 0; k < K; ++k) {
    for (int r = warp; r < kGroup; r += kWarps)
      tile[r][lane] = r < rg && y < n ? __ldg(dom + (static_cast<size_t>(r0 + r) * n + y) * K + k)
                                      : T(0);
    __syncthreads();
    for (int i = warp; i < 32 && y0 + i < n; i += kWarps)
      dom_t[((static_cast<size_t>(g) * n + y0 + i) * kGroup + lane) * K + k] = tile[lane][i];
    __syncthreads();  // the words and the tile's reads are done
  }
  if (warp == 0) {
    const uint32_t any = __ballot_sync(kFull, words[lane] != 0);
    if (lane == 0) any_bits[static_cast<size_t>(g) * ((n + 31) / 32) + blockIdx.x] = any;
  }
}

// Flags y = 32j .. 32j+31 of mask row `mrow` (n flags) as bits: one or two
// 16-byte loads when n is a multiple of 16 and the row 16-byte aligned.
__device__ __forceinline__ uint32_t mask_word(const uint8_t* __restrict__ mrow, int j, int n) {
  const int y0 = 32 * j;
  uint32_t bits = 0;
  if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(mrow) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(mrow + y0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (y0 + 16 * h >= n) break;
      const uint4 v = __ldg(src + h);
      const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          bits |= static_cast<uint32_t>(((q[i] >> (8 * b)) & 0xffu) != 0) << (16 * h + 4 * i + b);
    }
  } else {
    for (int b = 0; b < 32 && y0 + b < n; ++b)
      bits |= static_cast<uint32_t>(__ldg(mrow + y0 + b) != 0) << b;
  }
  return bits;
}

// Word i of a 16-byte read of the stage.
template <typename T>
__device__ __forceinline__ T word_of(const uint4& v, int i);
template <>
__device__ __forceinline__ uint32_t word_of<uint32_t>(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <>
__device__ __forceinline__ u64 word_of<u64>(const uint4& v, int i) {
  return i == 0 ? (static_cast<u64>(v.y) << 32 | v.x) : (static_cast<u64>(v.w) << 32 | v.z);
}

// The listed pairs (x, list[p]) of one warp against the group's rows, for
// the value a of this lane (a < d: a real value; else its result is never
// stored). Returns the lane's row mask: bit r set iff row r0 + r seeds some
// listed y and no word of entry (x, y, a) meets its domain at y. `net_x` is
// x's n·d entries, entry (y, a) at (y·d + a)·K pair-major or at (a·n + y)·K
// value-major (kValueMajor), `dom_t` the group's transposed domains (32 rows a
// variable, K words a row), `row_bits` the group's row masks, `stage` the
// warp's kStageBytes. U pairs a lane has in flight; an entry of KB words a
// round (KW > 0: all K at once; KW = 0: K read at run time, one a round).
template <typename T, int KW, bool kValueMajor>
__device__ __forceinline__ uint32_t test_pairs(const T* __restrict__ net_x,
                                               const T* __restrict__ dom_t,
                                               const uint32_t* __restrict__ row_bits,
                                               const uint16_t* list, T* stage, int np, int n,
                                               int d, int K, int a, int rg, int lane) {
  constexpr int KB = KW > 0 ? KW : 1;
  constexpr int U = KB == 1 ? 8 : (KB == 2 ? 4 : 2);
  constexpr int V = 16 / sizeof(T);  // rows a 16-byte read of the stage gives
  static_assert(U * KB * kGroup * sizeof(T) <= kStageBytes, "the stage holds U pairs");
  const bool value = a < d;
  uint32_t fail = 0;
  for (int p0 = 0; p0 < np; p0 += U) {
    int y[U];
    uint32_t rmask[U], sup[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = p0 + u < np;
      y[u] = ok ? list[p0 + u] : 0;
      rmask[u] = ok ? __ldg(row_bits + y[u]) : 0u;  // the same for every lane
      sup[u] = 0;
    }
    for (int k0 = 0; k0 < K; k0 += KB) {
      T e[U][KB], dl[U][KB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = p0 + u < np;
        const T* ent = net_x + (kValueMajor ? static_cast<size_t>(a) * n + y[u]
                                            : static_cast<size_t>(y[u]) * d + a) * K + k0;
        const T* dm = dom_t + (static_cast<size_t>(y[u]) * kGroup + lane) * K + k0;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          e[u][kk] = ok && value ? __ldg(ent + kk) : T(0);
          dl[u][kk] = ok ? __ldg(dm + kk) : T(0);
        }
      }
      __syncwarp();  // the stage's last readers are done
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) stage[(u * KB + kk) * kGroup + lane] = dl[u][kk];
      __syncwarp();
#pragma unroll
      for (int u = 0; u < U; ++u) {  // warp-uniform branches: every lane shuffles
        if (__popc(rmask[u]) > kFewRows) {
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            const uint4* src = reinterpret_cast<const uint4*>(stage + (u * KB + kk) * kGroup);
#pragma unroll
            for (int q = 0; q < kGroup / V; ++q) {
              if (q * V >= rg) break;
              const uint4 v = src[q];
#pragma unroll
              for (int i = 0; i < V; ++i)
                sup[u] |= static_cast<uint32_t>((e[u][kk] & word_of<T>(v, i)) != 0) << (q * V + i);
            }
          }
        } else {
          for (uint32_t m = rmask[u]; m; m &= m - 1) {
            const int r = __ffs(m) - 1;
            T hit = 0;
#pragma unroll
            for (int kk = 0; kk < KB; ++kk) hit |= e[u][kk] & __shfl_sync(kFull, dl[u][kk], r);
            sup[u] |= static_cast<uint32_t>(hit != 0) << r;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) fail |= rmask[u] & ~sup[u];
  }
  return fail;
}

// Values [c, c + 32) of x for every row of the group, from each lane's row
// mask `fail` (lane = value): 32 ballots give one value word a row, lane r
// keeps row r's, and writes its bytes (byte a = bit a), 16 or 4 bytes a
// store where the row's run is aligned.
__device__ __forceinline__ void store_rows(uint8_t* __restrict__ out, uint32_t fail, int x,
                                           int c, int nx, int d, int r0, int rg, int lane) {
  uint32_t mine = 0;
  for (int r = 0; r < rg; ++r) {
    const uint32_t word = __ballot_sync(kFull, (fail >> r) & 1u);
    if (lane == r) mine = word;
  }
  if (lane >= rg) return;
  const int nv = min(32, d - c);
  uint8_t* dst = out + (static_cast<size_t>(r0 + lane) * nx + x) * d + c;
  const auto expand = [](uint32_t nib) {  // 4 bits -> 4 bytes
    return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) | ((nib & 8u) << 21);
  };
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
  if ((nv & 15) == 0 && (at & 15) == 0) {
    for (int i = 0; i < nv / 16; ++i) {
      const uint32_t h = mine >> (16 * i);
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(expand(h & 0xfu), expand((h >> 4) & 0xfu), expand((h >> 8) & 0xfu),
                     expand((h >> 12) & 0xfu));
    }
  } else if ((nv & 3) == 0 && (at & 3) == 0) {
    for (int i = 0; i < nv / 4; ++i)
      reinterpret_cast<uint32_t*>(dst)[i] = expand((mine >> (4 * i)) & 0xfu);
  } else {
    for (int i = 0; i < nv; ++i) dst[i] = static_cast<uint8_t>((mine >> i) & 1u);
  }
}

// CTA (s, g): variables [s·span, (s+1)·span) of the block, rows
// [32g, 32g + 32) of B. span ≥ kWarps: warp w revises x ≡ w (mod kWarps)
// of the span, one at a time; span < kWarps (a divisor of it): the warps
// of a variable (kWarps / span) each take a share of its neighbour words
// and meet in a shared row-mask slot. Pair-major, s is blockIdx.x;
// value-major, g is, so the row groups of one span run side by side and
// meet in L2 on the entries they share.
template <typename T, int KW, bool kValueMajor>  // KW: words an entry, or 0: k_arg at run time
__global__ void __launch_bounds__(kThreads) block_revise_kernel(
    const T* __restrict__ net,              // (nx, n, d, K) pair-major, or (nx·d, n·K)
    const uint8_t* __restrict__ mask,       // (nx, n)
    const T* __restrict__ dom_t,            // (G, n, 32, K) the seed pass's domains
    const uint32_t* __restrict__ row_bits,  // (G, n) its row masks
    const uint32_t* __restrict__ any_bits,  // (G, ceil(n/32)) their unions
    uint8_t* __restrict__ out,              // (B, nx, d)
    int rows, int nx, int n, int d, int k_arg, int span) {
  const int K = KW > 0 ? KW : k_arg;
  const Smem L(n);
  extern __shared__ __align__(16) uint8_t block_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwn = (n + 31) / 32;
  uint32_t* any = reinterpret_cast<uint32_t*>(block_smem);
  uint16_t* list = reinterpret_cast<uint16_t*>(block_smem + L.list) + warp * kWindow;
  uint32_t* slots = reinterpret_cast<uint32_t*>(block_smem + L.slots);
  T* stage = reinterpret_cast<T*>(block_smem + L.stage + warp * kStageBytes);

  const int g = kValueMajor ? blockIdx.x : blockIdx.y, r0 = g * kGroup;
  const int rg = min(kGroup, rows - r0);
  const int x_begin = (kValueMajor ? blockIdx.y : blockIdx.x) * span;
  const int x_end = min(nx, x_begin + span);
  int seeded = 0;
  for (int j = tid; j < nwn; j += kThreads) {
    const uint32_t word = __ldg(any_bits + static_cast<size_t>(g) * nwn + j);
    any[j] = word;
    seeded |= word != 0;
  }
  if (!__syncthreads_or(seeded)) {  // no row of the group has a seed: all zeros
    const int len = (x_end - x_begin) * d;
    for (int i = tid; i < rg * len; i += kThreads) {
      const int r = i / len;
      out[(static_cast<size_t>(r0 + r) * nx + x_begin) * d + (i - r * len)] = 0;
    }
    return;
  }
  const int wpv = span < kWarps ? kWarps / span : 1;  // warps a variable
  const int per_pass = kWarps / wpv, v = warp / wpv, share = warp - v * wpv;
  const int spw = (nwn + wpv - 1) / wpv;  // neighbour words a warp of a variable takes
  const int j_begin = min(nwn, share * spw), j_end = min(nwn, j_begin + spw);
  const uint32_t* rbits = row_bits + static_cast<size_t>(g) * n;
  const T* dom_g = dom_t + static_cast<size_t>(g) * n * kGroup * K;
  uint32_t* slot = slots + 32 * v;
  for (int xp = x_begin; xp < x_end; xp += per_pass) {
    const int x = xp + v;
    const bool own = x < x_end;
    const uint8_t* mrow = mask + static_cast<size_t>(x) * n;
    const T* net_x = net + static_cast<size_t>(x) * n * d * K;
    for (int c = 0; c < d; c += 32) {  // values a lane: c + lane
      uint32_t fail = 0;
      if (own) {
        for (int w0 = j_begin; w0 < j_end; w0 += 32) {  // a window of neighbour words
          const int j = w0 + lane;
          uint32_t bits = j < j_end ? mask_word(mrow, j, n) & any[j] : 0u;
          const int cnt = __popc(bits);
          int end = cnt;
          for (int s = 1; s < 32; s <<= 1) {
            const int t = __shfl_up_sync(kFull, end, s);
            if (lane >= s) end += t;
          }
          const int np = __shfl_sync(kFull, end, 31);
          for (int k = end - cnt; bits; bits &= bits - 1)
            list[k++] = static_cast<uint16_t>(32 * j + __ffs(bits) - 1);
          __syncwarp();
          fail |= test_pairs<T, KW, kValueMajor>(net_x, dom_g, rbits, list, stage, np, n, d, K,
                                                 c + lane, rg, lane);
          __syncwarp();  // the list is rewritten for the next window
        }
      }
      if (wpv > 1) {  // the variable's warps meet in its slot (CTA-uniform branch)
        if (share == 0) slot[lane] = 0u;
        __syncthreads();
        if (own && fail) atomicOr(slot + lane, fail);
        __syncthreads();
        fail = slot[lane];
      }
      if (own && share == 0) store_rows(out, fail, x, c, nx, d, r0, rg, lane);
      if (wpv > 1) __syncthreads();  // the slot is zeroed for the next chunk
    }
  }
}

// Variables a CTA revises: the largest of 32, 16, 8, 4, 2, 1 that still
// gives the card kCtasPerSm CTAs an SM over the `groups` row groups.
inline int block_span(int nx, int groups) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long want = static_cast<long>(kCtasPerSm) * sms;
  int span = 32;
  while (span > 1 && static_cast<long>((nx + span - 1) / span) * groups < want) span /= 2;
  return span;
}

// The seed pass, then ceil(nx / span) × ceil(rows / 32) CTAs. `scratch`
// holds Scratch(rows, n, k · sizeof(T)).total bytes, 16-byte aligned.
// Refuses n above kMaxN and more than 65535 row groups; every offset is
// 64-bit. kValueMajor: `net` is the single-network layout (nx·d, n·k).
template <typename T, int KW, bool kValueMajor>
int launch(const void* net, const void* mask, const void* dom, const void* seed, void* scratch,
           void* out, int rows, int nx, int n, int d, int k, void* stream) {
  if (rows <= 0 || nx <= 0) return 0;
  const int groups = (rows + kGroup - 1) / kGroup;
  if (n <= 0 || n > kMaxN || d <= 0 || k <= 0 || groups > 65535 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch at(rows, n, k * static_cast<int>(sizeof(T)));
  uint8_t* base = static_cast<uint8_t*>(scratch);
  uint32_t* row_bits = reinterpret_cast<uint32_t*>(base);
  uint32_t* any_bits = reinterpret_cast<uint32_t*>(base + at.any);
  T* dom_t = reinterpret_cast<T*>(base + at.dom_t);
  seed_pass_kernel<T><<<dim3((n + 31) / 32, groups), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(seed), static_cast<const T*>(dom), row_bits, any_bits, dom_t,
      rows, n, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int span = block_span(nx, groups), spans = (nx + span - 1) / span;
  return static_cast<int>(fixpoint::launch_rows(
      block_revise_kernel<T, KW, kValueMajor>,
      kValueMajor ? dim3(groups, spans) : dim3(spans, groups), Smem(n).total, s,
      static_cast<const T*>(net), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(dom_t), static_cast<const uint32_t*>(row_bits),
      static_cast<const uint32_t*>(any_bits), static_cast<uint8_t*>(out), rows, nx, n, d, k,
      span));
}

}  // namespace block
