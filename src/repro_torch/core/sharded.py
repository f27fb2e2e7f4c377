"""Distributed RTAC on torch.distributed — the counterpart of
`repro.core.sharded`.

Sharding story: the constraint tensor is O(n²d²) and dominates memory, so
its *x*-rows are sharded over the ``model`` axis — each model rank revises
its own block of nx = n / |model| variables against the full (replicated)
domain tensor, then the updated domain blocks are all-gathered over
``model`` (B·n·d bool per recurrence, tiny next to the revise). The batch of
domains (search nodes) is split over the batch axes (``data``, and ``pod``
when present).

Every rank runs the same program on its own blocks: `shard_csp_arrays`
cuts a network and a domain batch into this rank's share, and the function
`make_sharded_enforcer` returns takes those blocks (the reference's
shard_map takes global arrays and cuts them itself). The reference vmaps a
``while_loop``, so each domain stops on its own; here the local batch runs
as one with an active mask (`rtac._fixpoint_rows`): a finished or wiped-out
domain keeps its state and its k. The loop predicate comes from the
gathered domain, so every rank of a model group decides alike, with one
host sync a recurrence and no collective beyond the all-gather, which goes
through `parallel.comm_stats`.

Local revise by variant (``impl``, ``dtype``):

- ``"bitpacked"``: the packed block revise (`packed_revise_block`) — the
  reference's ``_local_revise_bitpacked``; on CPU tensors its plain version;
- ``"einsum"`` with ``torch.uint8``: the dense block revise
  (`dense_revise_block`), the reference's dense u8 support test (PyTorch has
  no integer einsum on CUDA); d is padded to a multiple of 8 with values no
  domain holds;
- ``"einsum"`` with a float dtype (default bf16): ``torch.einsum`` chunked
  over x-rows and domains, as the reference leaves its contraction to XLA.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import bitpack_support, rtac_support
from repro_torch.kernels.ops import D_MULT
from repro_torch.kernels.ref import pack_bits_ref
from repro_torch.launch.mesh import axis_group
from repro_torch.parallel.comm_stats import all_gather

from . import rtac
from .rtac import EnforceResult

Tensor = torch.Tensor
#: elements a chunk of layout building or of the float einsum covers at most
_CHUNK = 1 << 25

LocalRevise = Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]


def variant(impl: str, dtype: torch.dtype) -> str:
    """"bitpacked", "u8" or "float": the block layout and local revise of
    (``impl``, ``dtype``)."""
    if impl == "bitpacked":
        return "bitpacked"
    if impl != "einsum":
        raise ValueError(f"unknown impl {impl!r} (einsum | bitpacked)")
    if dtype == torch.uint8:
        return "u8"
    if not dtype.is_floating_point:
        raise ValueError(f"impl='einsum' takes torch.uint8 or a float dtype, not {dtype}")
    return "float"


def block_layout(cons_rows: Tensor, impl: str, dtype: torch.dtype) -> Tensor:
    """This rank's network rows ``cons_rows`` (nx, n, d, d) bool in its
    variant's layout, the reference's pair-major order in all three (the d
    entries of one (x, y) pair contiguous), built in chunks of x-rows:
    bitpacked (nx, n, d, W) int32, the reference's ``cons_blk_pk``; u8
    (nx, n, d_p, d_p) with d_p = d rounded up to 8; float (nx, n, d, d) in
    ``dtype``."""
    kind = variant(impl, dtype)
    nx, n, d, _ = cons_rows.shape
    if kind == "float":
        return cons_rows.to(dtype)
    step = max(1, _CHUNK // (n * d * d))
    if kind == "bitpacked":
        out = torch.empty((nx, n, d, -(-d // 32)), dtype=torch.int32, device=cons_rows.device)
        for x0 in range(0, nx, step):
            out[x0:x0 + step] = pack_bits_ref(cons_rows[x0:x0 + step])
        return out
    d_p = -(-d // D_MULT) * D_MULT
    out = torch.zeros((nx, n, d_p, d_p), dtype=torch.uint8, device=cons_rows.device)
    for x0 in range(0, nx, step):
        out[x0:x0 + step, :, :d, :d] = cons_rows[x0:x0 + step]
    return out


def mask_layout(mask_rows: Tensor, impl: str, dtype: torch.dtype) -> Tensor:
    """This rank's mask rows (nx, n): u8 for the kernels, bool for einsum."""
    if variant(impl, dtype) == "float":
        return mask_rows.to(torch.bool).contiguous()
    return mask_rows.to(torch.uint8).contiguous()


def _revise_bitpacked(cons_blk: Tensor, mask_blk: Tensor, dom: Tensor, seed: Tensor, *,
                      plain: bool = False) -> Tensor:
    b, n, d = dom.shape
    w = -(-d // 32)
    words = pack_bits_ref(dom).reshape(b, n * w).contiguous()
    block = (bitpack_support.packed_revise_block_plain if plain
             else bitpack_support.packed_revise_block)
    viol = block(cons_blk, mask_blk, words, seed.to(torch.uint8).contiguous(), d=d, w=w)
    return viol.view(b, -1, d).bool()


def _revise_u8(cons_blk: Tensor, mask_blk: Tensor, dom: Tensor, seed: Tensor, *,
               plain: bool = False) -> Tensor:
    b, n, d = dom.shape
    d_p = cons_blk.shape[-1]
    dom_p = torch.zeros((b, n, d_p), dtype=torch.uint8, device=dom.device)
    dom_p[..., :d] = dom
    block = rtac_support.dense_revise_block_plain if plain else rtac_support.dense_revise_block
    viol = block(cons_blk, mask_blk, dom_p.view(b, n * d_p), seed.to(torch.uint8).contiguous(),
                 d=d_p)
    return viol.view(b, -1, d_p)[..., :d].bool()


def _revise_einsum(cons_blk: Tensor, mask_blk: Tensor, dom: Tensor, seed: Tensor, *,
                   plain: bool = False) -> Tensor:
    """The reference's ``_local_revise``: support counts in ``cons_blk``'s
    dtype (counts are integers, and only ``> 0`` is read), in chunks of
    x-rows and domains."""
    del plain  # a library call: the einsum is its own plain version
    b, n, d = dom.shape
    nx = cons_blk.shape[0]
    out = torch.empty((b, nx, d), dtype=torch.bool, device=dom.device)
    xs = max(1, min(nx, _CHUNK // (n * d)))
    bs = max(1, _CHUNK // (xs * n * d))
    dom_t = dom.to(cons_blk.dtype)
    for x0 in range(0, nx, xs):
        blk, m = cons_blk[x0:x0 + xs], mask_blk[x0:x0 + xs]
        for s in range(0, b, bs):
            cnt = torch.einsum("xyab,Byb->Bxya", blk, dom_t[s:s + bs])
            has = (cnt > 0) | ~m[None, :, :, None]
            out[s:s + bs, x0:x0 + xs] = (seed[s:s + bs, None, :, None] & ~has).any(dim=2)
    return out


_REVISE = {"bitpacked": _revise_bitpacked, "u8": _revise_u8, "float": _revise_einsum}


def local_revise(impl: str, dtype: torch.dtype, plain: bool = False) -> LocalRevise:
    """revise(cons_blk, mask_blk, dom (b, n, d) bool, seed (b, n) bool) ->
    violated (b, nx, d) bool of this rank's variables. ``plain``: the block
    kernels' plain versions on any device (the oracle of a run on the card)."""
    return functools.partial(_REVISE[variant(impl, dtype)], plain=plain)


def enforce_blocks(cons_blk: Tensor, mask_blk: Tensor, dom: Tensor, changed0: Tensor, *,
                   revise: LocalRevise, group, x_index: int) -> EnforceResult:
    """The sharded fixpoint of a local batch: each recurrence revises this
    rank's x-block (rows ``x_index·nx ..``), clears the violated values and
    all-gathers the blocks of ``group`` (the model axis) into the next
    domain. Per domain the reference's ``_enforce_one``: the seed starts as
    ``changed0 & consistent0``, ``changed = any(new_dom != dom)``."""
    nx = mask_blk.shape[0]
    x0 = x_index * nx

    def step(dom: Tensor, seed: Tensor) -> Tensor:
        new_blk = dom[:, x0:x0 + nx] & ~revise(cons_blk, mask_blk, dom, seed)
        return all_gather(new_blk, group, dim=1)

    return rtac._fixpoint_rows(step, dom.to(torch.bool), changed0.to(torch.bool))


def make_sharded_enforcer(
    mesh,
    model_axis: str = "model",
    batch_axes: Sequence[str] = ("data",),
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "einsum",  # "einsum" (paper-faithful dense) | "bitpacked"
):
    """Build ``enforce(cons_blk, mask_blk, dom_local, changed_local) ->
    EnforceResult`` of this rank's domains, on this rank's blocks
    (`shard_csp_arrays`): the network's x-rows of the ``model_axis`` shard
    in the (impl, dtype) layout, and the domains (b, n, d) and seeds (b, n)
    of its shard over ``batch_axes``. Every rank of the mesh calls it (the
    groups of several batch axes are made here)."""
    group, size, index = axis_group(mesh, (model_axis,))
    if model_axis in batch_axes:
        raise ValueError(f"{model_axis!r} is both the model axis and a batch axis")
    axis_group(mesh, batch_axes)
    revise = local_revise(impl, dtype)

    def enforce(cons_blk: Tensor, mask_blk: Tensor, dom: Tensor, changed: Tensor):
        n = dom.shape[1]
        if mask_blk.shape[0] * size != n:
            raise ValueError(f"{size} model shards of {mask_blk.shape[0]} variables != n={n}")
        return enforce_blocks(cons_blk, mask_blk, dom, changed, revise=revise, group=group,
                              x_index=index)

    return enforce


def batch_shard(mesh, batch_axes: Sequence[str], x: Tensor) -> Tensor:
    """This rank's rows of a (B, ...) batch split over ``batch_axes`` (B a
    multiple of their extent, as the reference's shard_map requires)."""
    _, size, index = axis_group(mesh, batch_axes)
    if x.shape[0] % size:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the batch extent {size}")
    b = x.shape[0] // size
    return x[index * b:(index + 1) * b]


def x_rows(mesh, model_axis: str, n: int) -> Tuple[int, int]:
    """[x0, x1): this rank's variables of an n-variable network."""
    _, size, index = axis_group(mesh, (model_axis,))
    if n % size:
        raise ValueError(f"n={n} is not a multiple of the model extent {size}")
    nx = n // size
    return index * nx, (index + 1) * nx


def _on(x, device: torch.device) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_csp_arrays(mesh, cons, mask, dom_batch, model_axis: str = "model",
                     batch_axes: Sequence[str] = ("data",), *, impl: str = "einsum",
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None):
    """This rank's blocks of a network and a domain batch, as
    `make_sharded_enforcer`'s function takes them: (cons_blk, mask_blk,
    dom_local). ``cons`` (n, n, d, d) and ``mask`` (n, n) are bool (numpy or
    tensors, the reference's arrays), ``dom_batch`` (B, n, d) bool. Placed on
    ``device`` (default: the mesh's device type)."""
    device = torch.device(mesh.device_type) if device is None else torch.device(device)
    mask = _on(mask, device).to(torch.bool)
    x0, x1 = x_rows(mesh, model_axis, mask.shape[0])
    cons_blk = block_layout(_on(cons[x0:x1], device).to(torch.bool), impl, dtype)
    mask_blk = mask_layout(mask[x0:x1], impl, dtype)
    dom = batch_shard(mesh, batch_axes, _on(dom_batch, device).to(torch.bool))
    return cons_blk, mask_blk, dom
