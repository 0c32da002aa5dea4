"""Slot-mapped paged KV cache: fixed block pool + per-slot page tables.

The port's counterpart of ``repro.serving.kv_cache`` for global-attention
layers with float32 / bfloat16 pools (the int8 pools and the windowed ring
come later).  Each attention layer's cache is a *pool* of fixed-size pages
shared by every decode slot::

    {"k": (N, P, K, hd), "v": (N, P, K, hd), "pos": (N, P) int32}

(``N`` pages of ``P`` tokens; ``pos`` is each entry's token position, -1 =
empty).  Layers of the repeated group are stacked over ``n_groups`` on a
leading axis, mirroring the reference's layout.

Indirection is by *page table*: slot ``s``'s logical page ``j`` lives at
physical page ``table[s, j]``.  Tables are built once per engine with pages
*interleaved* across slots (slot s's page j = j * n_slots + s), so
correctness depends on the indirection being followed.

Writes update the pools in place (the reference builds new pools): in-place
writes keep one copy of every pool.  Writes that must not land (inactive
slots, positions past the page budget, prompt padding) are masked out here;
the reference sends them to page id ``N`` and relies on JAX dropping
out-of-bounds scatters, which PyTorch does not do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

# block kinds the paged engine serves in the port
SERVABLE_KINDS = ("attn",)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def kv_dtype_of(cfg) -> str:
    """Resolved pool storage dtype name: ``cfg.kv_dtype`` overrides
    ``cfg.dtype`` when set (the activation dtype stays untouched)."""
    return cfg.kv_dtype or cfg.dtype


def check_servable(cfg) -> None:
    bad = [k for k in (*cfg.pattern, *cfg.tail) if k not in SERVABLE_KINDS]
    if bad:
        raise ValueError(
            f"{cfg.name}: the port's paged serving engine supports block "
            f"kinds {SERVABLE_KINDS}, got {bad} (not ported yet)"
        )


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Static paged-cache geometry for one (config, engine) pair."""

    n_slots: int
    page_size: int
    gp_cols: int           # logical pages per slot

    @property
    def n_global_pages(self) -> int:
        return self.n_slots * self.gp_cols


def build_spec(cfg, n_slots: int, max_total: int, page_size: int) -> PagedSpec:
    """max_total = max prompt + max generation length per request."""
    check_servable(cfg)
    return PagedSpec(
        n_slots=n_slots, page_size=page_size,
        gp_cols=math.ceil(max_total / page_size),
    )


def make_tables(spec: PagedSpec, device) -> torch.Tensor:
    """Global page table (S, gp) int32, interleaved: slot s's j-th page is
    physical page j * S + s."""
    s = torch.arange(spec.n_slots, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(spec.gp_cols, dtype=torch.int32, device=device)[None, :]
    return j * spec.n_slots + s


@dataclasses.dataclass
class PagedState:
    """Runtime handles threaded to the transformer via Ctx.paged."""

    global_table: torch.Tensor   # (S, gp) int32
    active: torch.Tensor         # (S,) bool — inactive writes are dropped
    page_size: int


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def init_pools(cfg, spec: PagedSpec, device) -> Dict[str, Any]:
    """Zeroed pools mirroring run_stack's cache layout:
    {"groups": {"<i>_<kind>": {"attn": pool}}}, stacked over n_groups."""
    K, hd = cfg.n_kv_heads, cfg.d_head
    dtype = _DTYPES[kv_dtype_of(cfg)]
    L, N, P = cfg.n_groups, spec.n_global_pages, spec.page_size

    def pool():
        return {
            "k": torch.zeros((L, N, P, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((L, N, P, K, hd), dtype=dtype, device=device),
            "pos": torch.full((L, N, P), -1, dtype=torch.int32, device=device),
        }

    return {
        "groups": {f"{i}_{kind}": {"attn": pool()}
                   for i, kind in enumerate(cfg.pattern)},
    }


def pool_bytes(cfg, spec: PagedSpec) -> int:
    """Total paged-pool footprint (all layers), for logging."""
    itemsize = torch.tensor([], dtype=_DTYPES[kv_dtype_of(cfg)]).element_size()
    per_page = spec.page_size * (cfg.n_kv_heads * cfg.d_head * 2 * itemsize + 4)
    return cfg.n_layers * spec.n_global_pages * per_page


# ---------------------------------------------------------------------------
# decode write (called from the transformer's decode branch, per layer)
# ---------------------------------------------------------------------------

def write_slots(positions, table, active, page_size: int):
    """Where a T-token chunk per slot lands: (b, t, page, offset) index
    tensors of the writes that are kept.  Writes of inactive slots, of
    positions < 0 and of positions past the page budget are dropped.  The
    selection waits for the card once (a boolean mask becomes indices), so a
    forward computes it once for all its layers."""
    C = table.shape[1]
    pos = positions.long()
    safe = pos.clamp(min=0)
    logical = safe // page_size
    ok = (pos >= 0) & (logical < C) & active[:, None]
    page = torch.gather(table.long(), 1, logical.clamp(max=C - 1))
    b_idx, t_idx = ok.nonzero(as_tuple=True)
    return b_idx, t_idx, page[b_idx, t_idx], safe[b_idx, t_idx] % page_size


def paged_cache_write(
    cache: Dict[str, torch.Tensor],   # {"k": (N,P,K,hd), "v": ..., "pos": (N,P)}
    k_new: torch.Tensor,              # (B, T, K, hd)
    v_new: torch.Tensor,
    positions: torch.Tensor,          # (B, T) int32; -1 = dropped
    table: torch.Tensor,              # (B, C) int32 — this slot batch's pages
    active: torch.Tensor,             # (B,) bool
    page_size: int,
    slots=None,                       # write_slots(...) of these arguments
) -> Dict[str, torch.Tensor]:
    """Write a T-token chunk per slot into its pages, in place; returns the
    pools.  Dropped writes as in :func:`write_slots`."""
    if slots is None:
        slots = write_slots(positions, table, active, page_size)
    b_idx, t_idx, pg, off = slots
    cache["pos"][pg, off] = positions[b_idx, t_idx].to(torch.int32)
    cache["k"][pg, off] = k_new[b_idx, t_idx].to(cache["k"].dtype)
    cache["v"][pg, off] = v_new[b_idx, t_idx].to(cache["v"].dtype)
    return cache


# ---------------------------------------------------------------------------
# admission: reset a slot's pages + page in a full-length prefill cache
# ---------------------------------------------------------------------------

def admit_slot(
    pools: Dict[str, Any],
    pcache: Dict[str, Any],
    cfg,
    spec: PagedSpec,
    gtab_row: torch.Tensor,          # (gp,) int32 — the slot's pages
    plen: int,                       # true prompt length
) -> Dict[str, Any]:
    """Page a (B=1) *full-length* prefill cache (``Model.forward(...,
    mode="prefill")``: every layer emits ``Pmax`` entries in identity order,
    padding dropped) into the slot's pages, in place.

    The slot's pages are first invalidated (pos = -1) so a previous
    occupant's entries can never alias the new request's positions; stale
    k/v bytes may remain but are masked by pos.
    """
    device = gtab_row.device
    rows = gtab_row.long()
    # prompt tokens that fit the slot's page budget; the rest (and the
    # padding past plen) is dropped
    n = min(int(plen), spec.gp_cols * spec.page_size)
    t = torch.arange(n, device=device)
    page = rows[t // spec.page_size]
    off = t % spec.page_size
    for i, kind in enumerate(cfg.pattern):
        key = f"{i}_{kind}"
        pool = pools["groups"][key]["attn"]
        src = pcache["groups"][key]["attn"]
        pool["pos"][:, rows] = -1
        pool["pos"][:, page, off] = t.to(torch.int32)
        pool["k"][:, page, off] = src["k"][:, 0, :n].to(pool["k"].dtype)
        pool["v"][:, page, off] = src["v"][:, 0, :n].to(pool["v"].dtype)
    return pools
