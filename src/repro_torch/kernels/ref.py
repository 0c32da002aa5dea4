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


def rmsnorm_bwd_ref(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients of :func:`rmsnorm_ref`: ``(dx, dgain)``, recomputing r
    from x.  ``dx = r (1 + g) dy - x r^3 / D * sum_j dy_j (1 + g_j) x_j``,
    ``dgain = sum_rows dy * x * r``; dx in x's dtype, dgain float32."""
    D = x.shape[-1]
    x32 = x.float().reshape(-1, D)
    dy32 = dy.float().reshape(-1, D)
    w = 1.0 + gain.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    dyw = dy32 * w
    rowdot = torch.sum(dyw * x32, dim=-1, keepdim=True)
    dx = r * dyw - x32 * (r * r * r / D) * rowdot
    dgain = torch.sum(dy32 * x32 * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dgain


def softmax_cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor):
    """Per-position ``(loss, lse)``, float32, shaped like ``labels``:
    ``lse = logsumexp(logits)`` and ``loss = lse - logits[label]``, with
    labels clamped to [0, V) (masking is the caller's)."""
    V = logits.shape[-1]
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    safe = labels.long().clamp(0, V - 1)
    picked = torch.gather(x, -1, safe[..., None])[..., 0]
    return lse - picked, lse


def softmax_cross_entropy_bwd_ref(logits: torch.Tensor, labels: torch.Tensor,
                                  lse: torch.Tensor, g: torch.Tensor):
    """``dlogits = (exp(logits - lse) - onehot(label)) * g``, typed like
    logits; labels clamped to [0, V) as in the forward."""
    V = logits.shape[-1]
    d = torch.exp(logits.float() - lse[..., None])
    safe = labels.long().clamp(0, V - 1)
    d.scatter_add_(-1, safe[..., None], torch.full_like(d[..., :1], -1.0))
    return (d * g.float()[..., None]).to(logits.dtype)
