"""Slot-mapped paged KV cache: fixed block pool + per-slot page tables.

The port's counterpart of ``repro.serving.kv_cache`` for global-attention
layers with float32, bfloat16 or int8 pools (the windowed ring comes
later).  Each attention layer's cache is a *pool* of fixed-size pages
shared by every decode slot::

    {"k": (N, P, K, hd), "v": (N, P, K, hd), "pos": (N, P) int32}

(``N`` pages of ``P`` tokens; ``pos`` is each entry's token position, -1 =
empty).  Layers of the repeated group are stacked over ``n_groups`` on a
leading axis, mirroring the reference's layout.

With ``cfg.kv_dtype == "int8"`` the k/v leaves hold int8 bytes and the pool
gains two f32 scale leaves ``{"k_scale", "v_scale"}: (N, K)`` — one
absmax/127 scale per page per kv head (see ``repro_torch.quant.kv``).  A
page's scale only grows while the page is live: every write scatter-maxes
the new tokens' scales into the page, requantizes the page's existing bytes
by old/new (round(int · old/new) — the same bytes when the scale did not
grow), then writes the new tokens at the final scale.  Invalidation zeroes
the scales with ``pos``.  Scales are indexed by the same physical page id
as the payload, so prefix sharing, eviction and re-admission move both or
neither.  The bytes and scales equal the reference's for the same inputs.

Indirection is by *page table*: slot ``s``'s logical page ``j`` lives at
physical page ``table[s, j]``.  The static engine builds its tables once
with pages *interleaved* across slots (slot s's page j = j * n_slots + s),
so correctness depends on the indirection being followed; the dynamic
engine takes them from ``serving/allocator.py`` and sizes its pools apart
from ``n_slots * gp_cols`` (``init_pools(n_global=)``).

Writes update the pools in place (the reference builds new pools): in-place
writes keep one copy of every pool.  Writes that must not land (inactive
slots, positions past the page budget, prompt padding) are masked out here;
the reference sends them to page id ``N`` and relies on JAX dropping
out-of-bounds scatters, which PyTorch does not do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.quant.core import _EPS, INT8_MAX, int8_scale

# block kinds the paged engine serves in the port
SERVABLE_KINDS = ("attn",)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


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


def build_spec(cfg, n_slots: int, max_total: int, page_size: int,
               lookahead: int = 0) -> PagedSpec:
    """max_total = max prompt + max generation length per request.

    ``lookahead`` is how far a forward's writes may run ahead of its
    earliest query (a prefill chunk, a speculative verify chunk); the
    reference widens its windowed rings by it.  The port serves global
    layers only, whose pages never wrap, so it changes nothing here.
    """
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

def init_pools(cfg, spec: PagedSpec, device,
               n_global: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed pools mirroring run_stack's cache layout:
    {"groups": {"<i>_<kind>": {"attn": pool}}}, stacked over n_groups.

    ``n_global`` overrides the pool size (default: the static interleaved
    geometry ``spec.n_global_pages``): the dynamic allocator sizes its pool
    apart from ``n_slots * gp_cols`` so prefix-cached pages can outlive
    their slot."""
    K, hd = cfg.n_kv_heads, cfg.d_head
    kv_name = kv_dtype_of(cfg)
    dtype = _DTYPES[kv_name]
    N = spec.n_global_pages if n_global is None else n_global
    L, P = cfg.n_groups, spec.page_size

    def pool():
        p = {
            "k": torch.zeros((L, N, P, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((L, N, P, K, hd), dtype=dtype, device=device),
            "pos": torch.full((L, N, P), -1, dtype=torch.int32, device=device),
        }
        if kv_name == "int8":
            p["k_scale"] = torch.zeros((L, N, K), dtype=torch.float32, device=device)
            p["v_scale"] = torch.zeros((L, N, K), dtype=torch.float32, device=device)
        return p

    return {
        "groups": {f"{i}_{kind}": {"attn": pool()}
                   for i, kind in enumerate(cfg.pattern)},
    }


def pool_bytes(cfg, spec: PagedSpec) -> int:
    """Total paged-pool footprint (all layers), for logging: k/v payload,
    positions and, for int8 pools, the per-page-per-head f32 scales."""
    kv_name = kv_dtype_of(cfg)
    itemsize = torch.tensor([], dtype=_DTYPES[kv_name]).element_size()
    per_page = spec.page_size * (cfg.n_kv_heads * cfg.d_head * 2 * itemsize + 4)
    if kv_name == "int8":
        per_page += 2 * cfg.n_kv_heads * 4     # k and v scales
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
    pools.  Dropped writes as in :func:`write_slots`; int8 pools through
    :func:`_quantized_write`."""
    if slots is None:
        slots = write_slots(positions, table, active, page_size)
    b_idx, t_idx, pg, off = slots
    cache["pos"][pg, off] = positions[b_idx, t_idx].to(torch.int32)
    if "k_scale" in cache:
        _quantized_write(cache["k"], cache["k_scale"], k_new[b_idx, t_idx], pg, off)
        _quantized_write(cache["v"], cache["v_scale"], v_new[b_idx, t_idx], pg, off)
        return cache
    cache["k"][pg, off] = k_new[b_idx, t_idx].to(cache["k"].dtype)
    cache["v"][pg, off] = v_new[b_idx, t_idx].to(cache["v"].dtype)
    return cache


def _quantized_write(store, scale, x_new, pg, off):
    """Write the kept tokens ``x_new`` (n, K, hd) at cells (pg, off) of an
    int8 pool ``store`` (N, P, K, hd) with scales ``scale`` (N, K), in place,
    in the reference's three steps:

      1. scatter-max the tokens' absmax/127 into their pages' scales
         (duplicate pages combine through max);
      2. requantize each touched page's bytes by old/new scale — ratio 1.0
         where the new scale is 0, so the bytes stay the same when the scale
         did not grow, and ratio 0 where a freshly invalidated page (scale 0)
         gets its first write, which wipes its stale bytes (duplicate pages
         write the same values);
      3. write the tokens quantized at the final scale.

    The ratio needs the scales from before step 1, which overwrites them in
    place: they are read first."""
    xf = x_new.float()
    s_tok = int8_scale(xf.abs().amax(dim=-1))            # (n, K)
    old = scale[pg]                                      # (n, K), a copy
    scale.index_reduce_(0, pg, s_tok, "amax")
    new = scale[pg]
    sn = new.clamp(min=_EPS)
    ratio = torch.where(new > 0, old / sn, 1.0)
    requant = torch.round(store[pg].float() * ratio[:, None, :, None])
    store[pg] = requant.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    q = torch.round(xf / sn[..., None])
    store[pg, off] = q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


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
    k/v bytes may remain but are masked by pos.  Int8 pools through
    :func:`_admit_quantized`.
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
        if "k_scale" in pool:
            for name in ("k", "v"):
                _admit_quantized(pool[name], pool[name + "_scale"],
                                 src[name][:, 0, :n], rows, page, off)
            continue
        pool["k"][:, page, off] = src["k"][:, 0, :n].to(pool["k"].dtype)
        pool["v"][:, page, off] = src["v"][:, 0, :n].to(pool["v"].dtype)
    return pools


def _admit_quantized(store, scale, src, rows, page, off):
    """Admission write into a stacked int8 pool (L, N, P, K, hd) with scales
    (L, N, K), in place: the scales of all the slot's ``rows`` start from
    zero, the prompt's ``src`` (L, n, K, hd) scatter-maxes into them, then
    every token is quantized at its page's final scale (nothing to
    requantize: the pages start empty)."""
    scale[:, rows] = 0.0
    sf = src.float()
    scale.index_reduce_(1, page, int8_scale(sf.abs().amax(dim=-1)), "amax")
    sn = scale[:, page].clamp(min=_EPS)[..., None]       # (L, n, K, 1)
    store[:, page, off] = torch.round(sf / sn).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


# ---------------------------------------------------------------------------
# page invalidation (dynamic allocator: freshly popped pages may hold a
# previous occupant's entries)
# ---------------------------------------------------------------------------

def invalidate_pages(pools: Dict[str, Any], cfg, g_pages) -> Dict[str, Any]:
    """Set pos = -1 on the given physical pages of every layer, in place,
    and zero their int8 scales; returns the pools.  Ids at or past the pool
    size are skipped (the reference pads its fixed-shape id arrays with the
    pool size and lets JAX drop the out-of-bounds scatter; PyTorch would
    raise, so they are masked out here).  Stale k/v bytes remain, masked by
    pos everywhere; an int8 page's stale bytes are wiped by its next
    write's requantization (old scale 0, ratio 0)."""
    for i, kind in enumerate(cfg.pattern):
        pool = pools["groups"][f"{i}_{kind}"]["attn"]
        pos = pool["pos"]
        ids = torch.as_tensor(g_pages, dtype=torch.long).reshape(-1)
        ids = ids[(ids >= 0) & (ids < pos.shape[1])].to(pos.device)
        pos[:, ids] = -1
        if "k_scale" in pool:
            pool["k_scale"][:, ids] = 0.0
            pool["v_scale"][:, ids] = 0.0
    return pools


# ---------------------------------------------------------------------------
# test/oracle helper
# ---------------------------------------------------------------------------

def gather_slot(pool: Dict[str, torch.Tensor], table_row) -> Dict[str, torch.Tensor]:
    """Contiguous {"k": (C*P, K, hd), "v": ..., "pos": (C*P,)} view of one
    slot's pages from an *unstacked* pool leaf (page ids clamped to the
    pool) — the dense-cache-shaped view the tests compare; int8 pages are
    dequantized to f32 by their scales."""
    N = pool["pos"].shape[-2]
    tab = torch.as_tensor(table_row).long().clamp(0, N - 1).to(pool["pos"].device)
    K, hd = pool["k"].shape[-2:]
    k, v = pool["k"][tab], pool["v"][tab]
    if "k_scale" in pool:
        k = k.float() * pool["k_scale"][tab][:, None, :, None]
        v = v.float() * pool["v_scale"][tab][:, None, :, None]
    return {
        "k": k.reshape(-1, K, hd),
        "v": v.reshape(-1, K, hd),
        "pos": pool["pos"][tab].reshape(-1),
    }
