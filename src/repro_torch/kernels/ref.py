"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Straight-line tensor code, the counterparts of ``repro.kernels.ref``.  The
CPU path runs them; on the card they are what each hand-written kernel is
held against.  One exception keeps tiles: :func:`flash_fwd_ref`, the plain
version of the flash-attention forward at the kernels' own contract, walks
the 64-key tiles because in the bf16 operand mode the kernel rounds the
unnormalized p of each tile, relative to the running row max, before it
multiplies it into v.
"""
from __future__ import annotations

import torch

from repro_torch.quant.core import kernel_dot, quant_matmul

NEG_INF = -2.3819763e38


def _visible(S: int, T: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, T) bool: query i sees key j (causal: j <= i; window: i - j < w)."""
    q_idx = torch.arange(S, device=device)[:, None]
    k_idx = torch.arange(T, device=device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= k_idx <= q_idx
    if window:
        mask &= (q_idx - k_idx) < window
    return mask


def attention_ref(
    q: torch.Tensor,          # (B, S, H, d)
    k: torch.Tensor,          # (B, T, K, d)
    v: torch.Tensor,          # (B, T, K, d)
    *,
    scale,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Causal / sliding-window / softcapped GQA attention in f32 (the
    flash-attention oracle); returns (B, S, H, d) in q's dtype.  Query head
    h reads kv head h // G."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, d).float()
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _visible(S, T, causal, window, q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, d).to(q.dtype)


def attention_policy_ref(
    q: torch.Tensor,          # (B, S, H, d)
    k: torch.Tensor,          # (B, T, K, d)
    v: torch.Tensor,          # (B, T, K, d)
    *,
    scale,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    policy=None,
) -> torch.Tensor:
    """:func:`attention_ref` with the q·kᵀ and p·v matmuls routed through
    the mixed-precision policy (``quant.quant_matmul``): the plain version
    of the dtype choices the flash kernels make per tile.  Differentiable,
    with the backward matmuls under the same policy; p·v multiplies the
    normalized softmax, where the kernels multiply the unnormalized p and
    divide after."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    kf = torch.repeat_interleave(k, G, dim=2)           # (B, T, H, d)
    vf = torch.repeat_interleave(v, G, dim=2)
    qt = q.transpose(1, 2).float()                      # (B, H, S, d)
    kt = kf.permute(0, 2, 3, 1).float()                 # (B, H, d, T)
    vt = vf.transpose(1, 2).float()                     # (B, H, T, d)
    logits = quant_matmul(qt, kt, policy) * scale       # (B, H, S, T)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _visible(S, T, causal, window, q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = quant_matmul(p, vt, policy)                   # (B, H, S, d)
    return out.transpose(1, 2).to(q.dtype)


FLASH_TILE = 64     # query rows and keys per tile of csrc/flash_attention.cu


def _heads(q, k, v):
    """q (B, H, S, d) and k, v repeated over each group, (B, H, T, d), f32."""
    G = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).float(),
            k.repeat_interleave(G, 2).transpose(1, 2).float(),
            v.repeat_interleave(G, 2).transpose(1, 2).float())


def _capped_logits(q, k, scale, softcap, policy):
    """(s, t): the logits before the mask, and the softcap's tanh (None
    without one)."""
    s = kernel_dot(q, k.transpose(-1, -2), policy) * scale
    if not softcap:
        return s, None
    t = torch.tanh(s / softcap)
    return softcap * t, t


def flash_fwd_ref(q, k, v, *, scale: float = 1.0, causal: bool = True,
                  window: int = 0, softcap: float = 0.0, policy=None):
    """The plain version of the flash forward (B5) at the kernel's contract:
    ``(o, lse)``, o in q's dtype, lse (B, H, S) float32.

    It keeps the kernel's algorithm where it decides the numbers: the
    64-key tiles, skipped where no pair of the (query tile, key tile) is
    visible, the online softmax (m, l, acc) with its alpha rescale, and
    under a bf16 policy each tile-matmul operand rounded to bf16 where the
    kernel rounds it: q and k, the unnormalized p = exp(s - m) of the tile
    and v.  Every query row is carried at once."""
    B, S, H, d = q.shape
    T = k.shape[1]
    qh, kh, vh = _heads(q, k, v)
    rows = torch.arange(S, device=q.device)
    q0 = rows // FLASH_TILE * FLASH_TILE              # each row's tile start
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, S, d, device=q.device)
    for k0 in range(0, T, FLASH_TILE):
        on = torch.ones_like(rows, dtype=torch.bool)  # _block_visible per row
        if causal:
            on &= k0 <= q0 + FLASH_TILE - 1
        if window:
            on &= k0 + FLASH_TILE - 1 >= q0 - window + 1
        if not bool(on.any()):
            continue
        ks = slice(k0, k0 + FLASH_TILE)
        s, _ = _capped_logits(qh, kh[:, :, ks], scale, softcap, policy)
        mask = _visible(S, T, causal, window, q.device)[:, ks]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        on = on[:, None]
        l = torch.where(on, alpha * l + p.sum(-1, keepdim=True), l)
        acc = torch.where(on, acc * alpha + kernel_dot(p, vh[:, :, ks], policy), acc)
        m = torch.where(on, m_new, m)
    lc = torch.clamp(l, min=1e-30)
    o = (acc / lc).transpose(1, 2).to(q.dtype)
    return o, (m + torch.log(lc))[..., 0]


def flash_bwd_ref(q, k, v, do, lse, delta, *, scale: float = 1.0,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  policy=None):
    """The plain version of the flash backward (B6 and B7) at the kernels'
    contract: ``(dq, dk, dv)`` float32, from the forward's lse and
    ``delta = rowsum(do * o)``, both (B, H, S).

    ``p = exp(s - lse)`` on the visible pairs and 0 elsewhere, ``ds = p (do
    vᵀ - delta)``, times the softcap's ``1 - t²`` (t the pre-mask tanh) and
    the scale; ``dq = ds k``, ``dk = dsᵀ q`` and ``dv = pᵀ do``, dk and dv
    summed over the G query heads of each kv head.  Under a bf16 policy the
    operands of every matmul are rounded to bf16, as the kernels round
    them: q and k, do and v, ds and k, pᵀ and do, dsᵀ and q.  No tiles: p
    and ds are elementwise, and a tile the kernels skip holds no visible
    pair."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    qh, kh, vh = _heads(q, k, v)
    doh = do.transpose(1, 2).float()
    s, t = _capped_logits(qh, kh, scale, softcap, policy)
    mask = _visible(S, T, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (kernel_dot(doh, vh.transpose(-1, -2), policy) - delta[..., None])
    if softcap:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = kernel_dot(ds, kh, policy)

    def per_kv_head(x):                               # (B, H, T, d) -> (B, T, K, d)
        return x.reshape(B, K, H // K, T, d).sum(2).transpose(1, 2)

    dk = per_kv_head(kernel_dot(ds.transpose(-1, -2), qh, policy))
    dv = per_kv_head(kernel_dot(p.transpose(-1, -2), doh, policy))
    return dq.transpose(1, 2), dk, dv


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
