// One incremental RTAC revise step over dense u8 networks, R rows per launch.
//
// Replaces two TPU kernels of src/repro/kernels/rtac_support.py:
// - dense_revise_stacked (body _revise_stacked_kernel): each row against its
//   own network, read through instance_idx. It is the stepped fixpoint's
//   revise (one launch per recurrence) — the fallback rung and the parity
//   oracle of the fused kernel (dense_fixpoint.cu). One CTA a row.
// - dense_revise (body _revise_kernel): B domains against ONE network — the
//   single-network path of enforce/enforce_batch and so of mac_solve, one
//   launch a recurrence; the reference vmaps it. Below n = 2048 a CTA per
//   (row, span of variables), the network compiled in as one; from n = 2048
//   block_revise.cuh's kernel on the value-major network
//   (dense_revise_wide_launch). On an x-block of a network, in the
//   reference's pair-major block layout, the sharded path's local revise is
//   block_revise.cuh's kernel too (dense_block_revise_launch).
// violated[r, x·d+a] = ∃y: seed[r,y] ∧ mask[x,y] ∧
//                      no byte of (cons2[x·d+a, y·d ..] & dom[r, y·d ..]) is nonzero.
// d is a multiple of 8 (ops.D_MULT), so each (x·a, y) slice is read as d/8
// aligned 8-byte words.
//
// Both kernels are revise_common.cuh's, an entry read as d/8 u64 words.
// What bounds them now (an H100, PERF.md): the stacked kernel, the rate of
// scattered 32-byte sectors of its root rows, two a test, from HBM (the
// tables outgrow L2); the single-network one, latency: 7.0 µs a launch on
// the calls of one mac_solve (the first design: 12.6), three dependent rounds
// of loads above a 1.9 µs launch floor. Measured and dropped, single
// network: one CTA a row (22.9 µs), d/8 = 5 read at run time (9.7 against
// 7.9 µs: a round of loads a word), cp.async staging of the seeded mask
// groups, 8 CTAs an SM; stacked: see revise_common.cuh. From n = 2048 (an
// H100 80GB HBM3 at 700 W, n=4096, d=32, PERF.md): 4.41 ms at B=512 (a
// variable a warp, the route it replaced: 102.9), one 32-byte sector an
// entry in either layout; 0.208 ms at B=1 (0.375). The single-network
// kernel's first design (a block per (row, 8 variables), a thread per
// (x·a, seeded y) pair, thread 0 listing the seed alone) was bound by
// latency too: serial seed loads, a division and a mask load per pair, and
// a seedless row paying as much as a seeded one.
//
// Widths compiled as constants: d/8 = 2 for the stacked kernel, as in
// dense_fixpoint.cu (where it measured faster), d/8 = 5 (the main shape)
// for the single-network one (measured faster, above), and d/8 = 4 (d = 32,
// the production CSP) for the block kernel in either layout. Any other
// d/8, and d/8 = 2 in the single-network kernel (no driven shape, not
// timed), is read at run time.
#include "block_revise.cuh"
#include "revise_common.cuh"

// R rows, row r against the slot table's network idx[r]: one CTA a row.
// `sched`: fixpoint::kCompiledWidth (d/8 = 2 as a constant) or
// kRuntimeWidth.
extern "C" int dense_revise_stacked_launch_sched(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* viol_out, int rows, int n, int d, int sched, void* stream) {
  if (!fixpoint::width_sched(sched)) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = sched == fixpoint::kCompiledWidth && d / 8 == 2
                       ? &revise::launch_stacked<revise::u64, 2>
                       : &revise::launch_stacked<revise::u64, 0>;
  return run(cons, mask, idx, dom_in, seed_in, viol_out, rows, n, d, d / 8, stream);
}

extern "C" int dense_revise_stacked_launch(
    const void* cons, const void* mask, const void* idx, const void* dom_in,
    const void* seed_in, void* viol_out, int rows, int n, int d, void* stream) {
  return dense_revise_stacked_launch_sched(cons, mask, idx, dom_in, seed_in, viol_out, rows, n,
                                           d, fixpoint::kCompiledWidth, stream);
}

// B rows against one network: a CTA per (row, span of variables). `span`
// (a multiple of 8, at most n rounded up to 8) is a tuned schedule; 0 takes
// revise::single_span's rule, as the unscheduled launcher does.
extern "C" int dense_revise_launch_sched(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in,
    void* viol_out, int rows, int n, int d, int span, void* stream) {
  const auto run = d / 8 == 5 ? &revise::launch_single<revise::u64, 5>
                              : &revise::launch_single<revise::u64, 0>;
  return run(cons, mask, dom_in, seed_in, viol_out, rows, n, d, d / 8, span, stream);
}

extern "C" int dense_revise_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in,
    void* viol_out, int rows, int n, int d, void* stream) {
  return dense_revise_launch_sched(cons, mask, dom_in, seed_in, viol_out, rows, n, d, 0, stream);
}

// B rows against an x-block of one network (this rank's nx variables of a
// sharded network, core/sharded.py), block_revise.cuh's kernel: cons
// (nx, n, d, d) pair-major, mask (nx, n), the domains (B, n·d) and seeds
// (B, n) over all n variables, `scratch` block::Scratch's bytes for the
// seed pass, out (B, nx·d). d/8 = 4 (d = 32, the sharded
// path's shapes) is compiled as a constant; any other d/8 is read at run
// time.
extern "C" int dense_block_revise_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in, void* scratch,
    void* viol_out, int rows, int nx, int n, int d, void* stream) {
  const auto run = d / 8 == 4 ? &block::launch<block::u64, 4, false>
                              : &block::launch<block::u64, 0, false>;
  return run(cons, mask, dom_in, seed_in, scratch, viol_out, rows, nx, n, d, d / 8, stream);
}

// B rows against ONE network in the single-network layout, dense_revise's
// route from n = 2048 (kernels/launch.py's SINGLE_WIDE_N): block_revise.cuh's
// kernel on the value-major network cons (n·d, n·d), nx = n; mask (n, n),
// the domains (B, n·d), seeds (B, n), `scratch` block::Scratch's bytes,
// out (B, n·d). Widths as dense_block_revise_launch.
extern "C" int dense_revise_wide_launch(
    const void* cons, const void* mask, const void* dom_in, const void* seed_in, void* scratch,
    void* viol_out, int rows, int n, int d, void* stream) {
  const auto run = d / 8 == 4 ? &block::launch<block::u64, 4, true>
                              : &block::launch<block::u64, 0, true>;
  return run(cons, mask, dom_in, seed_in, scratch, viol_out, rows, n, n, d, d / 8, stream);
}
