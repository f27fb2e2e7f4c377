// Pieces shared by the two fused fixpoint kernels (packed_fixpoint.cu,
// dense_fixpoint.cu): the shared-memory layout, the mask bits, the per-warp
// seed and lists, the support-test loop and the launch.
//
// Both kernels run one row's Jacobi recurrence in one CTA. Each variable x
// has one owner warp, x mod kWarps. In a sweep the owner tests x against its
// seeded neighbours, applies the removals and writes x's new domain and
// changed flag into the NEXT domain buffer; every warp reads only the
// CURRENT buffer. One barrier ends the sweep, then the buffers swap. So each
// sweep tests against the domain as it stood when the sweep began.
//
// The packed kernel may also split a row over a thread-block cluster of c
// CTAs (`split_span`, `launch_clusters`): each CTA owns a span of the row's
// variables and holds only their mask rows, and after each sweep every CTA
// copies the peers' spans of NEXT from their shared memory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fixpoint {

typedef unsigned long long u64;

constexpr int kThreads = 256;  // 8 warps a CTA (launch.FIXPOINT_WARPS)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // support tests a lane has in flight (8 for 4-byte entries)
constexpr unsigned kFull = 0xffffffffu;

// The width schedules of the fused fixpoints' and stacked revises'
// `*_launch_sched` launchers (kernels/autotune.py picks one per shape
// bucket): the instantiation compiled for the entry width where there is
// one, as the unscheduled launchers do, or the one that reads the width at
// run time.
constexpr int kCompiledWidth = 0, kRuntimeWidth = 1;
inline bool width_sched(int sched) { return sched == kCompiledWidth || sched == kRuntimeWidth; }

// The most CTAs a split row takes (the portable cluster size).
constexpr int kMaxSplit = 8;

// Variables a CTA of a row split over c CTAs owns, at most: ceil(n/c) rounded
// up to a multiple of 16, so that each span's domain words and changed flags
// are whole 16-byte pieces; n when the row is not split.
__host__ __device__ inline int split_span(int n, int c) {
  return c == 1 ? n : 16 * (((n + c - 1) / c + 15) / 16);
}

// Byte offsets into one CTA's dynamic shared memory; `total` is what
// launch.fixpoint_smem computes. Two domain buffers of `dom_bytes` each (a
// multiple of 4), then u32: the mask bits (n × ceil(n/32)), per-warp seed bits (ceil(n/32)) and violation words
// (ceil(d/32)), two wipe-out flags (buffered like the domain); u16: per-warp
// neighbour list (n) and value list (d); u8: two buffers of changed flags.
// A CTA of a row split over c > 1 CTAs holds the mask bits of its own span
// alone, and domain buffers and changed flags for c whole spans (the last
// may run past n), the flags 16-byte aligned.
struct Smem {
  int mbits, seed, viol, dead, ys, values, changed, total;
  __host__ __device__ Smem(int n, int d, int dom_bytes, int c = 1) {
    const int nwn = (n + 31) / 32, w = (d + 31) / 32;
    const int span = split_span(n, c), held = c == 1 ? n : c * span;
    mbits = 2 * (c == 1 ? dom_bytes : dom_bytes / n * held);
    seed = mbits + 4 * span * nwn;
    viol = seed + 4 * kWarps * nwn;
    dead = viol + 4 * kWarps * w;
    ys = dead + 8;
    values = ys + 2 * kWarps * n;
    changed = values + 2 * kWarps * d;
    if (c > 1) changed = (changed + 15) & ~15;
    total = changed + 2 * held;
  }
};

// Append the set bits of the warp-uniform `bits` as first + bit to
// list[count ..], in order; returns the new count.
__device__ __forceinline__ int append_bits(uint16_t* list, int count, uint32_t bits, int first,
                                           int lane) {
  if ((bits >> lane) & 1u)
    list[count + __popc(bits & ((1u << lane) - 1u))] = static_cast<uint16_t>(first + lane);
  return count + __popc(bits);
}

// `rows` rows of an (n, n) u8 mask as bits: byte b of row x's 4·ceil(n/32)
// bytes holds y = 8b .. 8b+7, so a row reads as little-endian 32-bit words.
// All threads take part; one aligned 8-byte load gives 8 flags when n is a
// multiple of 8.
__device__ __forceinline__ void load_mask_rows(const uint8_t* __restrict__ m, uint8_t* bits,
                                               int n, int rows) {
  const int nb = 4 * ((n + 31) / 32);
  const bool wide = (n & 7) == 0 && (reinterpret_cast<uintptr_t>(m) & 7) == 0;
  for (int i = threadIdx.x; i < rows * nb; i += kThreads) {
    const int x = i / nb, b = i - x * nb, y0 = 8 * b;
    const uint8_t* src = m + static_cast<size_t>(x) * n + y0;
    uint32_t f = 0;
    if (wide) {
      if (y0 < n) {
        const u64 v = __ldg(reinterpret_cast<const u64*>(src));
        for (int q = 0; q < 8; ++q)
          f |= static_cast<uint32_t>(((v >> (8 * q)) & 0xffu) != 0) << q;
      }
    } else {
      for (int q = 0; q < 8 && y0 + q < n; ++q)
        f |= static_cast<uint32_t>(__ldg(src + q) != 0) << q;
    }
    bits[x * nb + b] = static_cast<uint8_t>(f);
  }
}

// The whole (n, n) mask as bits.
__device__ void load_mask_bits(const uint8_t* __restrict__ m, uint8_t* bits, int n) {
  load_mask_rows(m, bits, n, n);
}

// This sweep's seed (the changed flags) as bits in the warp's `seed`, one
// ballot per 32 variables; returns whether any is set (warp-uniform).
__device__ __forceinline__ bool seed_bits(const uint8_t* changed, uint32_t* seed, int n,
                                          int lane) {
  uint32_t any = 0;
  for (int j = 0; 32 * j < n; ++j) {
    const int y = 32 * j + lane;
    const uint32_t b = __ballot_sync(kFull, y < n && changed[y]);
    if (lane == 0) seed[j] = b;
    any |= b;
  }
  __syncwarp();
  return any != 0;
}

// Whether x (mask bits `mrow`) has a seeded neighbour.
__device__ __forceinline__ bool constrained(const uint32_t* mrow, const uint32_t* seed, int nwn) {
  uint32_t hit = 0;
  for (int j = 0; j < nwn; ++j) hit |= mrow[j] & seed[j];
  return hit != 0;
}

// x's seeded neighbours into `ys`, in order; returns their count.
__device__ __forceinline__ int neighbours(const uint32_t* mrow, const uint32_t* seed, int nwn,
                                          uint16_t* ys, int lane) {
  int m = 0;
  for (int j = 0; j < nwn; ++j) m = append_bits(ys, m, mrow[j] & seed[j], 32 * j, lane);
  return m;
}

// The support tests of variable x, one warp: every (value a of `values`,
// neighbour y of `ys`) pair, y fastest, so lanes that share a value read
// neighbouring entries of one network row, and with one neighbour the lanes
// run over values. An entry is K words of T at net[(x·d + a)·n·K + y·K ..];
// a is supported by y iff some word ANDs nonzero with dom[y·K ..]. An
// unsupported a sets its bit in `viol` (the warp's violation words for x;
// removals are rare, so the shared atomic seldom fires). Each lane keeps U
// tests, KW·U loads, in flight: U = 2·kUnroll for one-word (4-byte)
// entries, kUnroll otherwise; KW = 0 reads K at run time.
template <typename T, int KW>
__device__ __forceinline__ void test_supports(const T* __restrict__ net, const T* dom, int x,
                                              int n, int d, int k_words,
                                              const uint16_t* values, int nv,
                                              const uint16_t* ys, int m, uint32_t* viol,
                                              int lane) {
  const int K = KW > 0 ? KW : k_words;
  constexpr int U = KW > 0 && KW * sizeof(T) <= 4 ? 2 * kUnroll : kUnroll;
  const size_t row_stride = static_cast<size_t>(n) * K;
  const int q = 32 / m, rem = 32 % m;  // a step of 32 tests, without a division
  int ai = lane / m, yi = lane - ai * m;
  for (int base = 0; base < nv * m; base += 32 * U) {
    const T* src[U];
    const T* dy[U];
    int a[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = ai < nv;
      a[u] = ok[u] ? values[ai] : 0;
      const int y = ok[u] ? ys[yi] : 0;
      src[u] = net + static_cast<size_t>(x * d + a[u]) * row_stride + static_cast<size_t>(y) * K;
      dy[u] = dom + y * K;
      ai += q;
      yi += rem;
      if (yi >= m) {
        yi -= m;
        ++ai;
      }
    }
    T sup[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sup[u] = 0;
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) sup[u] |= __ldg(src[u] + j) & dy[u][j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u] && sup[u] == 0) atomicOr(&viol[a[u] >> 5], 1u << (a[u] & 31));
  }
}

// Launch `kernel` on `grid` (one CTA per row, or per (row, span of
// variables)), opting in to more than 48 KB of shared memory when the
// layout needs it.
template <typename... Params, typename... Args>
cudaError_t launch_rows(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t stream,
                        Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The launch of `kernel` over rows × c CTAs as clusters of c (a row a
// cluster), opting in to more than 48 KB of shared memory when the layout
// needs it; `cfg` points to `attr`, the cluster attribute.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int rows, int c, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Launch `kernel` with a row a cluster of c CTAs (`cluster_config`).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int rows, int c, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kernel, rows, c, smem, stream, cfg, attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of c CTAs of `kernel` the card holds at once, into
// *clusters: 0 where not even one fits.
template <typename Kernel>
cudaError_t max_clusters(Kernel kernel, int c, size_t smem, cudaStream_t stream, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = cluster_config(kernel, 1, c, smem, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
}

}  // namespace fixpoint
