// Fused incremental RTAC fixpoint over dense u8 networks, R rows per launch.
//
// Replaces the TPU kernel src/repro/kernels/rtac_support.py::
// dense_fixpoint_stacked (body _fixpoint_stacked_kernel): every row runs its
// own Jacobi recurrence to convergence inside one launch — support test =
// any byte of (cons2[x·d+a, y·d .. y·d+d) & dom[y·d .. y·d+d)) nonzero,
// dom &= ~violated, k += 1 per sweep the row was active — and the launch
// writes the domain bytes, the consistency bit and k.
//
// What bounded the first design (one thread per (x·a, seeded y) pair, one
// CTA per row): bookkeeping and the one-CTA tail, not bytes. It read five
// times the packed kernel's bytes per test yet took only 1.13× its time
// on an H100 (PERF.md): two integer divisions, a shared load and a global mask
// load per pair, constrained or not (6.5 % are, at the main shape), and a
// launch as long as the root row one CTA walked alone.
//
// Design: that of packed_fixpoint.cu (fixpoint_common.cuh), with the domain
// held as bytes:
// - each sweep a warp tests, for each variable x it owns, exactly the pairs
//   (value still in x's domain) × (seeded neighbour of x), lanes over pairs
//   with neighbours fastest; an entry is the d-byte slice cons2[x·d+a,
//   y·d ..], read as d/8 aligned 8-byte words (d is a multiple of 8,
//   ops.D_MULT), 4 tests a lane in flight; d/8 = 2 is compiled as a
//   constant (15-18 % faster than reading it at run time at the dense-mask
//   shape), every other d/8 is read at run time (at d/8 = 5, the main
//   shape, a constant measured 7 % slower on the main path's row mix);
// - the owner warp applies x's removals byte by byte, detects change and
//   wipe-out, and writes x's bytes into the other domain buffer; one barrier
//   a sweep;
// - one CTA per row (thread-block clusters measured slower for this kernel
//   at every shape and row mix, PERF.md).
// The row's network is read in place from the slot table through
// instance_idx: a 17 MB dense network cannot sit in 227 KB of shared memory.
//
// What bounds it now (measured on an H100, PERF.md): bytes from HBM. A test
// reads d bytes (two 32-byte sectors at d = 40), and the dense tables
// (554 MB at the main shape, 210 MB at the dense-mask shape) are several
// times L2.
#include "fixpoint_common.cuh"

namespace {

using namespace fixpoint;

template <int KW>  // 8-byte words per entry (d/8), or 0: d/8 at run time
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
  const int d8 = KW > 0 ? KW : d / 8;
  const int nd = n * d, nwn = (n + 31) / 32, w = (d + 31) / 32;
  const Smem L(n, d, nd);
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* const dom0 = smem;  // the two domain buffers; nd is a multiple of 8
  uint8_t* const dom1 = smem + nd;
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
  const u64* net = reinterpret_cast<const u64*>(cons + slot * static_cast<size_t>(nd) * nd);

  const u64* row_in = reinterpret_cast<const u64*>(dom_in + static_cast<size_t>(r) * nd);
  for (int i = threadIdx.x; i < nd / 8; i += kThreads)
    reinterpret_cast<u64*>(dom0)[i] = row_in[i];
  for (int x = threadIdx.x; x < n; x += kThreads)
    changed0[x] = seed_in[static_cast<size_t>(r) * n + x] != 0;
  if (threadIdx.x < 2) dead[threadIdx.x] = 0u;
  load_mask_bits(mask + slot * n * n, smem + L.mbits, n);
  __syncthreads();
  bool empty = false;  // a variable with no value at entry: the row does no sweep
  for (int x = threadIdx.x; x < n; x += kThreads) {
    u64 any = 0;
    for (int j = 0; j < d8; ++j) any |= reinterpret_cast<const u64*>(dom0 + x * d)[j];
    empty |= any == 0;
  }
  bool consistent = !__syncthreads_or(empty);

  int k = 0, p = 0;
  while (consistent && seed_bits(p ? changed1 : changed0, seed, n, lane)) {
    const uint8_t* cur = p ? dom1 : dom0;
    uint8_t* next = p ? dom0 : dom1;
    uint8_t* next_changed = p ? changed0 : changed1;
    for (int x0 = warp; x0 < n; x0 += 32 * kWarps) {  // this warp owns x ≡ warp mod 8
      const int x = x0 + lane * kWarps;  // one owned variable per lane
      const bool hit = x < n && constrained(mbits + x * nwn, seed, nwn);
      if (x < n && !hit) {  // no seeded neighbour: x keeps its domain
        const u64* from = reinterpret_cast<const u64*>(cur + x * d);
        u64* to = reinterpret_cast<u64*>(next + x * d);
        for (int j = 0; j < d8; ++j) to[j] = from[j];
        next_changed[x] = 0;
      }
      for (uint32_t todo = __ballot_sync(kFull, hit); todo; todo &= todo - 1) {
        const int xv = x0 + (__ffs(todo) - 1) * kWarps;  // the whole warp revises xv
        const uint8_t* bytes = cur + xv * d;
        int nv = 0;
        for (int j = 0; j < w; ++j) {
          const int a = 32 * j + lane;
          nv = append_bits(values, nv, __ballot_sync(kFull, a < d && bytes[a] != 0), 32 * j, lane);
        }
        const int m = neighbours(mbits + xv * nwn, seed, nwn, ys, lane);
        for (int j = lane; j < w; j += 32) viol[j] = 0u;
        __syncwarp();
        test_supports<u64, KW>(net, reinterpret_cast<const u64*>(cur), xv, n, d, d8, values, nv,
                               ys, m, viol, lane);
        __syncwarp();
        bool diff = false, alive = false;
        for (int a = lane; a < d; a += 32) {
          const uint8_t old = bytes[a];
          const bool gone = (viol[a >> 5] >> (a & 31)) & 1u;
          const uint8_t kept = static_cast<uint8_t>(gone ? old & 0xfe : old);
          diff |= kept != old;
          alive |= kept != 0;
          next[xv * d + a] = kept;
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

  const u64* fin = reinterpret_cast<const u64*>(p ? dom1 : dom0);
  u64* out = reinterpret_cast<u64*>(dom_out + static_cast<size_t>(r) * nd);
  for (int i = threadIdx.x; i < nd / 8; i += kThreads) out[i] = fin[i];
  if (threadIdx.x == 0) {
    consistent_out[r] = consistent ? 1 : 0;
    k_out[r] = k;
  }
}

}  // namespace

// `sched`: kCompiledWidth (d/8 = 2 as a constant) or kRuntimeWidth.
extern "C" int dense_fixpoint_stacked_launch_sched(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, int sched, void* stream) {
  if (rows <= 0) return 0;
  if (!width_sched(sched)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = sched == kCompiledWidth && d / 8 == 2 ? &dense_fixpoint_kernel<2>
                                                            : &dense_fixpoint_kernel<0>;
  return static_cast<int>(launch_rows(
      kernel, rows, Smem(n, d, n * d).total, static_cast<cudaStream_t>(stream),
      static_cast<const uint8_t*>(cons), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(dom_in),
      static_cast<const uint8_t*>(seed_in), static_cast<uint8_t*>(dom_out),
      static_cast<uint8_t*>(consistent_out), static_cast<int32_t*>(k_out), n, d));
}

extern "C" int dense_fixpoint_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* dom_out, void* consistent_out, void* k_out,
    int rows, int n, int d, void* stream) {
  return dense_fixpoint_stacked_launch_sched(cons, mask, idx, dom_in, seed_in, dom_out,
                                             consistent_out, k_out, rows, n, d,
                                             kCompiledWidth, stream);
}
