// One incremental RTAC revise step over bitpacked networks, R rows per launch.
//
// Replaces two TPU kernels of src/repro/kernels/bitpack_support.py:
// - packed_revise_stacked (body _revise_packed_stacked_kernel): each row
//   against its own network, read through instance_idx. It is the stepped
//   fixpoint's revise (one launch per recurrence) — the fallback rung and the
//   parity oracle of the fused kernel. One CTA a row.
// - packed_revise (body _revise_packed_kernel): B domains against ONE
//   network — the single-network path of enforce/enforce_batch and so of
//   mac_solve, one launch a recurrence; the reference vmaps it. Below
//   n = 2048 a CTA per (row, span of variables), the network compiled in as
//   one; from n = 2048 block_revise.cuh's kernel on the value-major network
//   (packed_revise_wide_launch). On an x-block of a network, in the
//   reference's pair-major block layout, the sharded path's local revise is
//   block_revise.cuh's kernel too (packed_block_revise_launch).
// violated[r, x·d+a] = ∃y: seed[r,y] ∧ mask[x,y] ∧ (cons[x·d+a, y·W..] & dom[r, y·W..]) == 0.
//
// Both kernels are revise_common.cuh's, with u32 words (W per entry). What
// bounds them now (an H100, PERF.md): the stacked kernel, the rate of
// scattered 32-byte sectors of its root rows; the single-network one,
// latency: 5.4 µs a launch on the calls of one mac_solve (the first design:
// 11.0), three dependent rounds of loads above a 1.9 µs launch floor. From
// n = 2048 (an H100 80GB HBM3 at 700 W, n=4096, d=32, PERF.md): 0.847 ms at
// B=512 (a variable a warp, the route it replaced: 32.80), the sectors of
// the pairs' values; 0.171 ms at B=1 (0.184).
// Measured and dropped, single network: one CTA a row (11.6 µs), cp.async
// staging of the seeded mask groups, 8 CTAs an SM; stacked: see
// revise_common.cuh. The single-network kernel's first design (a block per
// (row, 8 variables), a thread per (x·a, seeded y) pair, thread 0 listing
// the seed alone) was bound by latency too: serial seed loads, a division
// and a mask load per pair, and a seedless row paying as much as a seeded
// one.
//
// An entry of W = 2 words is read as one 8-byte word where the table and
// the domains are 8-byte aligned; the stacked kernel also compiles W = 1 as
// a constant (8 tests a lane in flight), as packed_fixpoint.cu does, and so
// does the block kernel in either layout (W = 1 at the production CSP's
// d = 32). Any other W, and W = 1 in the single-network kernel below
// n = 2048 (no driven shape, not timed), is read at run time.
#include "block_revise.cuh"
#include "revise_common.cuh"

// Whether W = 2 entries go as one 8-byte word: the table and the domains are
// 8-byte aligned.
static bool wide_words(int w, const void* cons, const void* dom_in) {
  return w == 2 && ((reinterpret_cast<uintptr_t>(cons) |
                     reinterpret_cast<uintptr_t>(dom_in)) & 7) == 0;
}

// R rows, row r against the slot table's network idx[r]: one CTA a row.
// `sched`: fixpoint::kCompiledWidth (W = 1, and W = 2 as one 8-byte word)
// or kRuntimeWidth (W u32 words read at run time).
extern "C" int packed_revise_stacked_launch_sched(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* viol_out, int rows, int n, int d, int w, int sched,
    void* stream) {
  if (!fixpoint::width_sched(sched)) return static_cast<int>(cudaErrorInvalidValue);
  const bool compiled = sched == fixpoint::kCompiledWidth;
  if (compiled && wide_words(w, cons, dom_in))
    return revise::launch_stacked<revise::u64, 1>(cons, mask, idx, dom_in, seed_in, viol_out,
                                                  rows, n, d, 1, stream);
  const auto run = compiled && w == 1 ? &revise::launch_stacked<uint32_t, 1>
                                      : &revise::launch_stacked<uint32_t, 0>;
  return run(cons, mask, idx, dom_in, seed_in, viol_out, rows, n, d, w, stream);
}

extern "C" int packed_revise_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* viol_out, int rows, int n, int d, int w, void* stream) {
  return packed_revise_stacked_launch_sched(cons, mask, idx, dom_in, seed_in, viol_out, rows, n,
                                            d, w, fixpoint::kCompiledWidth, stream);
}

// B rows against one network: a CTA per (row, span of variables). `span`
// (a multiple of 8, at most n rounded up to 8) is a tuned schedule; 0 takes
// revise::single_span's rule, as the unscheduled launcher does.
extern "C" int packed_revise_launch_sched(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in,
    void* viol_out, int rows, int n, int d, int w, int span, void* stream) {
  if (wide_words(w, cons, dom_in))
    return revise::launch_single<revise::u64, 1>(cons, mask, dom_in, seed_in, viol_out, rows,
                                                 n, d, 1, span, stream);
  return revise::launch_single<uint32_t, 0>(cons, mask, dom_in, seed_in, viol_out, rows, n, d,
                                            w, span, stream);
}

extern "C" int packed_revise_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in,
    void* viol_out, int rows, int n, int d, int w, void* stream) {
  return packed_revise_launch_sched(cons, mask, dom_in, seed_in, viol_out, rows, n, d, w, 0,
                                    stream);
}

// B rows against an x-block of one network (this rank's nx variables of a
// sharded network, core/sharded.py), block_revise.cuh's kernel: cons
// (nx, n, d, W) pair-major, mask (nx, n), the domains (B, n·W) and seeds
// (B, n) over all n variables, `scratch` block::Scratch's bytes for the
// seed pass, out (B, nx·d). W = 2 entries go as one 8-byte
// word where the block and the domains are 8-byte aligned, W = 1 as a
// constant; any other W is read at run time.
extern "C" int packed_block_revise_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in, void* scratch,
    void* viol_out, int rows, int nx, int n, int d, int w, void* stream) {
  if (wide_words(w, cons, dom_in))
    return block::launch<block::u64, 1, false>(cons, mask, dom_in, seed_in, scratch, viol_out,
                                               rows, nx, n, d, 1, stream);
  const auto run =
      w == 1 ? &block::launch<uint32_t, 1, false> : &block::launch<uint32_t, 0, false>;
  return run(cons, mask, dom_in, seed_in, scratch, viol_out, rows, nx, n, d, w, stream);
}

// B rows against ONE network in the single-network layout, packed_revise's
// route from n = 2048 (kernels/launch.py's SINGLE_WIDE_N): block_revise.cuh's
// kernel on the value-major network cons (n·d, n·W), nx = n; mask (n, n),
// the domains (B, n·W), seeds (B, n), `scratch` block::Scratch's bytes,
// out (B, n·d). Widths as packed_block_revise_launch.
extern "C" int packed_revise_wide_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in, void* scratch,
    void* viol_out, int rows, int n, int d, int w, void* stream) {
  if (wide_words(w, cons, dom_in))
    return block::launch<block::u64, 1, true>(cons, mask, dom_in, seed_in, scratch, viol_out,
                                              rows, n, n, d, 1, stream);
  const auto run =
      w == 1 ? &block::launch<uint32_t, 1, true> : &block::launch<uint32_t, 0, true>;
  return run(cons, mask, dom_in, seed_in, scratch, viol_out, rows, n, n, d, w, stream);
}
