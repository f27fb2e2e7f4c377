"""Bitpacked RTAC kernels for Hopper, each beside its plain PyTorch version.

The counterpart of `repro.kernels.bitpack_support`. Networks are packed on
the value axis b into 32-bit words (held as ``int32`` with the reference's
uint32 bit patterns):

    cons[s, x·d + a, y·W + w]   int32,  W = ceil(d/32), one slot s per network
    has[x,a,y] = any_w(cons_word & dom_word) != 0  ∨  ¬mask[x,y]
    violated[x,a] = ∃y: seed[y] ∧ ¬has[x,a,y]

Both kernels take the slot TABLES and a row→slot map ``idx`` and read each
row's network in place — no per-round gathered copy of the networks:

- :func:`packed_revise_stacked` — one revise step for R rows
  (``csrc/packed_revise.cu``; the stepped fixpoint's revise);
- :func:`packed_fixpoint_stacked` — the whole incremental fixpoint of R rows
  in one launch (``csrc/packed_fixpoint.cu``; the fused default).

Device rule: a wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches its kernel or raises — it never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import build
from .ref import pack_bits_ref, unpack_bits_ref

Tensor = torch.Tensor

#: dynamic shared memory a block may use without an opt-in attribute
_SMEM_LIMIT = 48 * 1024


def _check(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor, changed: Tensor,
           d: int, w: int) -> Tuple[int, int]:
    """Validate the operands both kernels take; returns (R, n)."""
    c, nd, nw = cons.shape
    n = nd // d
    r = idx.shape[0]
    expect = {
        "cons": (cons, torch.int32, (c, n * d, n * w)),
        "mask": (mask, torch.uint8, (c, n, n)),
        "idx": (idx, torch.int32, (r,)),
        "dom_words": (dom_words, torch.int32, (r, n * w)),
        "changed": (changed, torch.uint8, (r, n)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != cons.device:
            raise ValueError(f"{name} is on {t.device}, cons on {cons.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nw != n * w or w != -(-d // 32):
        raise ValueError(f"cons columns {nw} != n*W with W=ceil({d}/32)")
    if cons.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cons.device}")
    return r, n


_SIGNATURES = {
    "packed_fixpoint": ("packed_fixpoint_stacked_launch", 8),
    "packed_revise": ("packed_revise_stacked_launch", 6),
}


def _lib(name: str) -> ctypes.CDLL:
    """The kernel library with its C signatures bound (pointers as c_void_p,
    so ctypes never truncates them to 32 bits)."""
    lib = build.load(name)
    fn_name, n_ptrs = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, tensors: List[Tensor], r: int, n: int, d: int, w: int) -> None:
    fn = getattr(_lib(name), _SIGNATURES[name][0])
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], r, n, d, w, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _revise_chunk_rows(n: int, d: int, w: int) -> int:
    """Rows per chunk of the plain revise (bounds its gathered working set)."""
    return max(1, (1 << 28) // (n * d * n * w * 4))


# ---------------------------------------------------------------------------
# One revise step (stepped fixpoint)
# ---------------------------------------------------------------------------


def packed_revise_stacked_plain(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                                changed: Tensor, *, d: int, w: int) -> Tensor:
    """Plain PyTorch version of `packed_revise_stacked` (same operands, same
    result), gathering row networks in chunks."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    step = _revise_chunk_rows(n, d, w)
    for s in range(0, r, step):
        ii = idx[s:s + step].long()
        rows = ii.shape[0]
        net = cons[ii].view(rows, n, d, n, w)  # (rows, x, a, y, w)
        dw = dom_words[s:s + step].view(rows, 1, 1, n, w)
        has = ((net & dw) != 0).any(dim=-1)  # (rows, x, a, y)
        has |= mask[ii].bool()[:, :, None, :].logical_not()
        seed = changed[s:s + step].bool()[:, None, None, :]
        out[s:s + step] = (seed & ~has).any(dim=-1).view(rows, n * d).to(torch.uint8)
    return out


def packed_revise_stacked(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                          changed: Tensor, *, d: int, w: int) -> Tensor:
    """R packed revisions, row r against network ``cons[idx[r]]``.

    cons (C, n·d, n·W) int32, mask (C, n, n) u8, idx (R,) int32,
    dom_words (R, n·W) int32, changed (R, n) u8 -> violated (R, n·d) u8."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    if cons.device.type == "cpu":
        return packed_revise_stacked_plain(cons, mask, idx, dom_words, changed, d=d, w=w)
    smem = (n * w + n) * 4 + 8 * d
    if smem > _SMEM_LIMIT:
        raise ValueError(f"packed_revise_stacked: n·W={n * w} needs {smem} B of shared "
                         f"memory, more than its layout's {_SMEM_LIMIT} B")
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    if r:
        _launch("packed_revise", [cons, mask, idx, dom_words, changed, out], r, n, d, w)
        packed_revise_stacked.launches += 1
    return out


packed_revise_stacked.launches = 0


# ---------------------------------------------------------------------------
# The fused fixpoint (one launch per round)
# ---------------------------------------------------------------------------


def packed_fixpoint_stacked_plain(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                                  changed: Tensor, *, d: int, w: int,
                                  seeds_out: Optional[list] = None):
    """Plain PyTorch version of `packed_fixpoint_stacked`: the same per-row
    recurrence as a host loop over `packed_revise_stacked_plain` sweeps.
    ``seeds_out``, if a list, receives each sweep's (R, n) seed — what a
    caller needs to count the work these inputs require."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    words = dom_words.view(r, n, w)
    consistent = (words != 0).any(dim=-1).all(dim=-1)
    ch = changed.bool() & consistent[:, None]
    k = torch.zeros(r, dtype=torch.int32, device=cons.device)
    while True:
        active = consistent & ch.any(dim=-1)
        if not bool(active.any()):
            break
        seed = ch & active[:, None]
        if seeds_out is not None:
            seeds_out.append(seed)
        viol = packed_revise_stacked_plain(
            cons, mask, idx, words.reshape(r, n * w).contiguous(),
            seed.to(torch.uint8), d=d, w=w,
        )
        new = words & ~pack_bits_ref(viol.view(r, n, d).bool())
        ch = (new != words).any(dim=-1)
        consistent = consistent & (new != 0).any(dim=-1).all(dim=-1)
        k += active.to(torch.int32)
        words = new
    dom = unpack_bits_ref(words, d).reshape(r, n * d).to(torch.uint8)
    return dom, consistent.to(torch.uint8), k


def packed_fixpoint_stacked(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                            changed: Tensor, *, d: int, w: int):
    """R packed fixpoints in ONE launch, row r against ``cons[idx[r]]``.

    Operands as `packed_revise_stacked` (``changed`` is the Prop. 2 seed,
    assignment already applied to ``dom_words``). Returns (dom (R, n·d) u8
    unpacked, consistent (R,) u8, k (R,) int32) — per row bit-identical to
    the stepped fixpoint."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    if cons.device.type == "cpu":
        return packed_fixpoint_stacked_plain(cons, mask, idx, dom_words, changed, d=d, w=w)
    smem = (2 * n * w + n) * 4 + n
    if smem > _SMEM_LIMIT:
        raise ValueError(f"packed_fixpoint_stacked: n·W={n * w} needs {smem} B of shared "
                         f"memory, more than its layout's {_SMEM_LIMIT} B")
    dom = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    consistent = torch.empty((r,), dtype=torch.uint8, device=cons.device)
    k = torch.empty((r,), dtype=torch.int32, device=cons.device)
    if r:
        _launch("packed_fixpoint", [cons, mask, idx, dom_words, changed, dom, consistent, k],
                r, n, d, w)
        packed_fixpoint_stacked.launches += 1
    return dom, consistent, k


packed_fixpoint_stacked.launches = 0


def reset_launches() -> None:
    """Zero every wrapper's launch count."""
    packed_revise_stacked.launches = 0
    packed_fixpoint_stacked.launches = 0

