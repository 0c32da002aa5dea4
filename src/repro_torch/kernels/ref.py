"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Straight-line tensor code (no tiling, no online softmax), the counterparts of
``repro.kernels.ref``.  The CPU path runs them; on the card they are what
each hand-written kernel is held against.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def decode_attention_ref(
    q: torch.Tensor,            # (B, H, d) — one query per decode slot
    k_pages: torch.Tensor,      # (N, P, K, d) — paged KV pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32 token positions; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids per slot
    q_pos: torch.Tensor,        # (B,) int32 query positions; -1 = inactive slot
    *,
    scale,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Single-query attention over a paged KV cache (the flash-decode oracle).

    Gathers each slot's pages into a contiguous (C*P) band and masks by the
    *stored* token positions: an entry is visible iff pos >= 0, pos <= q_pos
    and (windowed) q_pos - pos < window.  Fully-masked rows (inactive slots,
    q_pos = -1) return exact zeros.
    """
    B, H, d = q.shape
    N, P, K, _ = k_pages.shape
    C = page_table.shape[1]
    G = H // K
    tab = page_table.long().clamp(0, N - 1)
    k = k_pages[tab].float().reshape(B, C * P, K, d)
    v = v_pages[tab].float().reshape(B, C * P, K, d)
    pos = pos_pages[tab].reshape(B, C * P)
    qp = q_pos[:, None]
    mask = (pos >= 0) & (pos <= qp)
    if window:
        mask &= (qp - pos) < window
    qg = q.reshape(B, K, G, d).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    m = mask[:, None, None, :]
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    # all-masked rows: NEG_INF is finite so softmax is uniform, not NaN —
    # zero it so inactive slots contribute exact 0s (kernel contract)
    p = torch.where(m, p, torch.zeros_like(p))
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    return out.reshape(B, H, d).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + gain.float())
    return y.to(x.dtype)
