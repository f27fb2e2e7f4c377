"""``packed_revise_roofline``: kernel 3 (`packed_revise`) from n = 2048, the
block revise's route (`csrc/block_revise.cuh`: its seed pass and revise), as
a share of its roofline: the byte bound of every traced call's recurrences
(`lib.roofline`, from the plain fixpoint's seeds) over the two kernels'
device time in the traced slice."""

from rtacbench.lib.trace import seconds_of


def read(rec):
    t, bound = rec["trace"], rec["counts"].get("revise_bound_s")
    if t is None or bound is None:
        return None
    s = seconds_of(t, "block_revise_kernel", "seed_pass_kernel")
    return None if not s else 100.0 * bound / s
