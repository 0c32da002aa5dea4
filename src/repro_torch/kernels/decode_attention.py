"""Paged flash decode: the wrappers of the hand-written CUDA kernels.

``flash_decode`` (B8, one query per slot) replaces the TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``; ``flash_decode_multi``
(B9, a chunk of T queries per slot: chunked prefill, prefix-cache
suffixes, speculative verify) replaces ``_decode_multi_kernel``.  Both take
float32, bfloat16 and int8 pools; int8 pools come with ``(N, K)`` float32
per-page-per-head scales (``k_scale``, ``v_scale``) and are dequantized in
the kernel as each page is read, as the TPU kernels do under ``kv_quant``.
B8 splits each slot's pages over a cluster of ``decode_splits(B, K, C)``
blocks of ``DECODE_WARPS`` warps and merges them in one launch; B9 gives a
block a tile of ``tq`` queries (``tq`` x G rows) and splits the tile's
pages over a cluster of ``splits`` blocks, both chosen by
the kernel's own ``multi_plan`` (its C entry point
``repro_flash_decode_multi_plan`` gives the wrapper's refusal;
``decode_multi_plan`` mirrors it for the CPU tests, and chip_smoke.py
holds the two equal on the card).  The source and its design note are
``csrc/decode_attention.cu``.  Each wrapper launches its kernel on CUDA
tensors or raises, and counts its own launches, the int8-pool launches
apart (``int8_launches``, ``multi_int8_launches``); the plain versions are
``kernels/ref.py::decode_attention_ref`` and ``decode_attention_multi_ref``,
chosen by ``kernels/ops.py`` for CPU tensors;
``decode_attention_split_ref`` and ``decode_attention_multi_split_ref``
walk B8's and B9's splits and merges.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

DECODE_WARPS = 4          # warps a B8 block (csrc/decode_attention.cu kWarps)
MAX_SPLITS = 8            # blocks a B8 cluster: the portable cluster size
MAX_GRID_Y = 65535        # the grid's second dimension: kv heads (B8 and B9)
# B9's plan, mirrored from csrc/decode_attention.cu (kMaxRows, kRowLanes,
# kPsLd, kSplitFixed, kMaxDynSmem), which owns them
MULTI_MAX_ROWS = 64       # query rows (tq x G) a block holds
MULTI_ROW_LANES = 16      # lanes that share a row; a slice is 64 x cv columns
MULTI_PS_LD = 80          # floats a row of the step's p
SMS = 132                 # SMs of an H100 SXM (the kernel reads its device's count)
SPLIT_FIXED = 150         # a B9 block's fixed time in (page, row) pairs of products
MAX_DYN_SMEM = 232448     # 227 KB: the most shared memory a block may opt in to
_INVALID_CONFIGURATION = 9   # cudaErrorInvalidConfiguration: the plan cannot place it

launches = 0              # B8 launches over f32/bf16 pools in this process
multi_launches = 0        # B9 launches over f32/bf16 pools
int8_launches = 0         # B8 launches over int8 pools
multi_int8_launches = 0   # B9 launches over int8 pools


def _check(what, q, k_pages, v_pages, pos_pages, page_table, q_pos, q_rank,
           k_scale=None, v_scale=None):
    """Raise unless the arguments fit the kernel: CUDA, one device,
    contiguous, shapes, dtypes, int32 indexing, and (N, K) float32 scales
    exactly when the pools are int8.  Returns (B, H, d)."""
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages,
                   page_table=page_table, q_pos=q_pos)
    int8 = k_pages.dtype == torch.int8
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise ValueError(f"{what} kernel: k_scale and v_scale go with int8 pools "
                         f"and only with them (pools {k_pages.dtype})")
    if int8:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what} kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous {name}")
    if q.ndim != q_rank or k_pages.ndim != 4:
        layout = "(B, H, d)" if q_rank == 3 else "(B, T, H, d)"
        raise ValueError(f"q must be {layout} and pools (N, P, K, d), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, d = q.shape[0], q.shape[-2], q.shape[-1]
    N, P, K, dk = k_pages.shape
    C = page_table.shape[-1]
    if 0 in (N, P, K, d) or v_pages.shape != k_pages.shape or dk != d or H % K:
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}"
        )
    if tuple(pos_pages.shape) != (N, P) or tuple(page_table.shape) != (B, C) \
            or tuple(q_pos.shape) != tuple(q.shape[:-2]):
        raise ValueError(
            f"pos {tuple(pos_pages.shape)}, table {tuple(page_table.shape)}, "
            f"q_pos {tuple(q_pos.shape)} do not fit q {tuple(q.shape)}, "
            f"N={N}, P={P}"
        )
    if q.dtype not in _Q_CODES or k_pages.dtype not in _KV_CODES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{what} kernel takes float32/bfloat16 q and "
                         f"float32/bfloat16/int8 pools, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if int8:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if tuple(t.shape) != (N, K) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be ({N}, {K}) float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    for name in ("pos_pages", "page_table", "q_pos"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if k_pages.numel() >= 2**31 or q.numel() >= 2**31:
        raise ValueError(f"{what} kernel: sizes exceed int32 indexing")
    return B, H, d


def decode_splits(B: int, K: int, C: int) -> int:
    """B8's blocks per (slot, kv head): a cluster of min(8, C), whose
    S x DECODE_WARPS warps share the slot's live pages (page j to warp
    j mod S x DECODE_WARPS).  B and K do not change it: only the table's
    width C does."""
    return max(1, min(MAX_SPLITS, C))


class MultiPlan(NamedTuple):
    """B9's launch plan: ``tq`` queries a tile, ``splits`` blocks a cluster,
    ``tiles`` tiles over T, the block's pages in ``slots`` slots of
    ``stage_pages`` pages (two slots: a ring), column slices of 64 x ``cv``
    and the shared memory a block needs (bytes)."""
    tq: int
    splits: int
    tiles: int
    stage_pages: int
    slots: int
    cv: int
    smem: int


def _up16(n):
    return (n + 15) // 16 * 16


def multi_smem_bytes(R, S, H, slots, d, P, C, kv_bytes, slice_cols):
    """Shared memory of a B9 block (csrc/decode_attention.cu MultiLayout):
    page ids, the slots' K (row stride d + 4 floats where d is a multiple
    of 8) and V in f32, the raw bytes of bf16/int8 pools, positions,
    scales, q, the step's p and the merge stage, each 16-byte aligned."""
    dpad = (d + 3) // 4 * 4
    ldk = dpad + 4 if dpad % 8 == 0 else dpad
    sw = min(dpad, slice_cols)
    rs = -(-R // S)
    row_bytes = _up16(d * kv_bytes)
    pages = slots * H
    parts = [-(-C // S) * 4, pages * P * ldk * 4, pages * P * dpad * 4,
             0 if kv_bytes == 4 else pages * 2 * P * row_bytes, pages * P * 4,
             pages * 2 * 4, R * dpad * 4, R * MULTI_PS_LD * 4, S * rs * 4, S * rs * 4,
             S * rs * sw * 4, rs * S * 4, rs * 4]
    return sum(_up16(n) for n in parts)


def _multi_refusal(G, d, P, need):
    """The ValueError of a shape B9's plan cannot place, with the bytes of
    shared memory the smallest layout would need."""
    if G > MULTI_MAX_ROWS:
        return ValueError(f"flash_decode_multi kernel: G={G} query heads a kv head need "
                          f"{G} rows and {need} bytes of shared memory for one query; a "
                          f"block holds {MULTI_MAX_ROWS} rows")
    return ValueError(f"flash_decode_multi kernel: G={G}, d={d}, P={P} needs {need} bytes "
                      f"of shared memory for a ring of two one-page slots (at most "
                      f"{MAX_DYN_SMEM})")


def decode_multi_plan(B: int, K: int, T: int, G: int, d: int, P: int, C: int,
                      kv_bytes: int = 4, sms: int = SMS) -> MultiPlan:
    """B9's plan on a card of ``sms`` SMs, as the kernel's ``multi_plan``
    makes it (a mirror for the CPU tests; the wrapper asks the kernel):
    tiles of at most MULTI_MAX_ROWS rows, balanced over T; the splits S <=
    min(8, C) that minimise waves(S) x (SPLIT_FIXED S + C tq G), waves(S)
    = ceil(B K tiles S / sms), so the grid fills the card through the
    splits while a block's fixed cost still pays for itself; every page a
    block may own (ceil(C / S)) in one slot where that fits MAX_DYN_SMEM,
    else a ring of two slots of as many pages as fit; where not even one
    page a slot fits beside the tile's rows (gemma2-2b's d_head 256 over
    int8 pools at 64 rows), balanced tiles of fewer queries, down to one.
    Raises ValueError, with the bytes the smallest layout would need, where
    the shape cannot be placed (G > MULTI_MAX_ROWS, or one page a slot does
    not fit at one query a tile)."""
    cv = 1 if d <= 64 else 4
    cols = MULTI_ROW_LANES * 4 * cv
    T, C = max(T, 1), max(C, 1)
    if G > MULTI_MAX_ROWS:
        raise _multi_refusal(G, d, P, multi_smem_bytes(G, 1, 1, 1, d, P, C, kv_bytes, cols))
    n = -(-T // (MULTI_MAX_ROWS // G))
    tq = -(-T // n)
    while True:
        tiles = -(-T // tq)
        bkt, work = B * K * tiles, C * tq * G
        splits, best = 1, None
        for S in range(1, min(MAX_SPLITS, C) + 1):   # compared as integers, cost = num / S
            num = -(-(bkt * S) // sms) * (SPLIT_FIXED * S + work)
            if best is None or num * splits < best * S:
                splits, best = S, num
        ppb = -(-C // splits)
        smem = multi_smem_bytes(tq * G, splits, ppb, 1, d, P, C, kv_bytes, cols)
        if smem <= MAX_DYN_SMEM:
            return MultiPlan(tq, splits, tiles, ppb, 1, cv, smem)
        for h in range(ppb - 1, 0, -1):
            smem = multi_smem_bytes(tq * G, splits, h, 2, d, P, C, kv_bytes, cols)
            if smem <= MAX_DYN_SMEM:
                return MultiPlan(tq, splits, tiles, h, 2, cv, smem)
        if tq == 1:
            raise _multi_refusal(G, d, P, multi_smem_bytes(G, splits, 1, 2, d, P, C,
                                                           kv_bytes, cols))
        tq = -(-T // -(-T // (tq - 1)))     # balanced tiles of at most tq - 1 queries


def kernel_multi_plan(B: int, K: int, T: int, G: int, d: int, P: int, C: int,
                      kv_bytes: int = 4) -> MultiPlan:
    """B9's plan as the kernel makes it on the current CUDA device (the C
    entry point ``repro_flash_decode_multi_plan``); raises ValueError where
    it cannot place the shape, as :func:`decode_multi_plan` does."""
    import ctypes

    got = (ctypes.c_int * 6)()
    smem = build.library().repro_flash_decode_multi_plan(
        B, K, T, G, d, P, C, {4: 0, 2: 1, 1: 2}[kv_bytes], got)
    if smem < 0:
        build.check(-smem, "flash_decode_multi plan")
    if got[0] == 0:
        raise _multi_refusal(G, d, P, smem)
    return MultiPlan(*got, smem)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_decode(
    q: torch.Tensor,            # (B, H, d) — one query per slot
    k_pages: torch.Tensor,      # (N, P, K, d) paged pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids
    q_pos: torch.Tensor,        # (B,) int32; -1 = inactive slot -> zeros out
    *,
    scale: float = 1.0,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: torch.Tensor | None = None,   # (N, K) f32 — int8 pools only
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paged single-query flash attention; returns (B, H, d) in q's dtype.

    Query head h reads kv head h // G (kv-major GQA layout, G = H // K).
    Page ids are clamped to [0, N - 1]; rows with q_pos < 0 are zeros.
    Int8 pools are read as ``int8 * scale[page, kv head]`` in f32.  Any
    G, d and P; at most 65535 kv heads (the grid's second dimension).
    """
    global launches, int8_launches
    B, H, d = _check("flash_decode", q, k_pages, v_pages, pos_pages,
                     page_table, q_pos, 3, k_scale, v_scale)
    N, P, K, _ = k_pages.shape
    C = page_table.shape[-1]
    if K > MAX_GRID_Y:
        raise ValueError(f"flash_decode kernel: K={K} kv heads, at most "
                         f"{MAX_GRID_Y} (the grid's second dimension)")
    lib = build.library()
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out.zero_()
    err = lib.repro_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), page_table.data_ptr(), q_pos.data_ptr(),
        _ptr(k_scale), _ptr(v_scale),
        out.data_ptr(), B, H, K, d, N, P, C, float(scale), int(window),
        float(softcap), decode_splits(B, K, C), _Q_CODES[q.dtype],
        _KV_CODES[k_pages.dtype], build.stream(q),
    )
    build.check(err, "flash_decode kernel")
    if k_scale is None:
        launches += 1
    else:
        int8_launches += 1
    return out


def flash_decode_multi(
    q: torch.Tensor,            # (B, T, H, d) — T queries per slot
    k_pages: torch.Tensor,      # (N, P, K, d) paged pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids
    q_pos: torch.Tensor,        # (B, T) int32; -1 rows -> zeros out
    *,
    scale: float = 1.0,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: torch.Tensor | None = None,   # (N, K) f32 — int8 pools only
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paged multi-query flash attention; returns (B, T, H, d) in q's dtype.

    Row (b, t) sees the entries of slot b's pages with 0 <= pos <=
    q_pos[b, t] (and inside the window); the chunk must already be written
    into the pages.  Query head h reads kv head h // G.  Page ids are
    clamped to [0, N - 1]; rows with q_pos < 0 are zeros.  Int8 pools as in
    :func:`flash_decode`.  Any T, G <= 64, d and P that the kernel's plan
    can place (:func:`kernel_multi_plan`); at most 65535 kv heads.
    """
    global multi_launches, multi_int8_launches
    B, H, d = _check("flash_decode_multi", q, k_pages, v_pages, pos_pages,
                     page_table, q_pos, 4, k_scale, v_scale)
    T = q.shape[1]
    N, P, K, _ = k_pages.shape
    C = page_table.shape[-1]
    if K > MAX_GRID_Y:
        raise ValueError(f"flash_decode_multi kernel: K={K} kv heads, at most "
                         f"{MAX_GRID_Y} (the grid's second dimension)")
    lib = build.library()
    out = torch.empty_like(q)
    if B == 0 or T == 0 or C == 0:
        return out.zero_()
    err = lib.repro_flash_decode_multi(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), page_table.data_ptr(), q_pos.data_ptr(),
        _ptr(k_scale), _ptr(v_scale),
        out.data_ptr(), B, T, H, K, d, N, P, C, float(scale), int(window),
        float(softcap), 0, 0, _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype],
        build.stream(q),
    )
    if err == _INVALID_CONFIGURATION:   # the plan's own refusal, with the bytes it needs
        kernel_multi_plan(B, K, T, H // K, d, P, C, k_pages.element_size())
    build.check(err, "flash_decode_multi kernel")
    if k_scale is None:
        multi_launches += 1
    else:
        multi_int8_launches += 1
    return out
