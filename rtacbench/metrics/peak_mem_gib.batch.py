"""``peak_mem_gib.batch``: `torch.cuda.max_memory_allocated()` over set-up
and window, in GiB: memory traded for speed shows here."""


def read(rec):
    peak = rec["memory_peak_bytes"]
    return peak / 2**30 if peak else None
