"""``packed_fixpoint_stacked_roofline``: kernel 1 (`packed_fixpoint_stacked`,
`csrc/packed_fixpoint.cu`) as a share of its roofline: the byte bound of
the traced call's rounds (`lib.roofline`, from the plain fixpoint's seeds of
a seeded sample of its solves, scaled to all of them) over the kernel's
device time in the traced slice."""

from rtacbench.lib.trace import seconds_of


def read(rec):
    t, bound = rec["trace"], rec["counts"].get("fixpoint_bound_s")
    if t is None or bound is None:
        return None
    s = seconds_of(t, "packed_fixpoint_kernel")
    return None if not s else 100.0 * bound / s
