"""``packed_revise_small_b_roofline``: kernel 3 (`packed_revise`) on its wide
route at `mac_solve`'s few rows a call (`csrc/block_revise.cuh`: its seed
pass and revise), as a share of its roofline: the byte bound of the traced
solves' revise calls (`lib.roofline`, from the seeds the plain MAC search's
fixpoints observe, one call a recurrence) over the two kernels' device time
in the traced slice."""

from rtacbench.lib.trace import seconds_of


def read(rec):
    t, bound = rec["trace"], rec["counts"].get("revise_bound_s")
    if t is None or bound is None:
        return None
    s = seconds_of(t, "block_revise_kernel", "seed_pass_kernel")
    return None if not s else 100.0 * bound / s
