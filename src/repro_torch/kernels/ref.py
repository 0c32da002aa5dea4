"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Straight-line tensor code, the counterparts of ``repro.kernels.ref``.  The
CPU path runs them; on the card they are what each hand-written kernel is
held against.  One exception keeps tiles: :func:`flash_fwd_ref` and
:func:`flash_bwd_ref`, the plain versions of the flash-attention kernels at
their own contract, walk the kernels' tiles (``FLASH_TILES``) where the
tiling decides the numbers: the forward rounds (bf16) or quantizes (int8)
the unnormalized p of each key tile relative to the running row max, and
in the int8 mode every tile matmul takes its scales over the tile.  In the
bf16 mode their products over d (q·kᵀ, do·vᵀ) are summed in the
tensor-core kernels' order (:func:`_mma_dot`), where the rounding of p and
ds to bf16 makes the order visible.
"""
from __future__ import annotations

import torch

from repro_torch.quant.core import kernel_dot, quant_matmul, quantize_int8

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


# (query rows, keys) per tile of csrc/flash_attention.cu, by kernel and
# operand mode.  The reference's model tiles 128 x 128 (repro kernels/ops.py
# block_q = block_k = 128).  An axis whose width changes the numbers is 128
# wide: B5's keys in every mode (p = exp(s - m) is rounded or quantized
# relative to the running max over the tiles seen), B6's keys and B7's
# queries in the int8 mode (ds·k takes its scales over the tile's keys, pᵀ·do
# and dsᵀ·q over its queries).  The other axis stays 64: a row's numbers do
# not depend on it, so a kernel may block it otherwise (B5's tensor-core
# kernel blocks 128 query rows): a tile that a block visits but a row sees
# no key of adds exact zeros to that row, or is wiped by the next tile's
# alpha = 0.
FLASH_TILES = {
    "fwd": {"none": (64, 128), "bf16": (64, 128), "int8": (64, 128)},
    "dq": {"none": (64, 64), "bf16": (64, 64), "int8": (64, 128)},
    "dkv": {"none": (64, 64), "bf16": (64, 64), "int8": (128, 64)},
}


def flash_tile(kernel: str, policy) -> tuple:
    """(query rows, keys) per tile of ``kernel`` ("fwd", "dq" or "dkv")
    under ``policy``."""
    mode = getattr(policy, "matmul", "none") if policy is not None else "none"
    return FLASH_TILES[kernel][mode]


def _heads(q, k, v):
    """q (B, H, S, d) and k, v repeated over each group, (B, H, T, d), f32."""
    G = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).float(),
            k.repeat_interleave(G, 2).transpose(1, 2).float(),
            v.repeat_interleave(G, 2).transpose(1, 2).float())


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_dot(a, b):
    """``a @ b`` over d as the tensor-core kernels sum it (bf16 operands,
    Hopper's mma.sync m16n8k16 with f32 accumulators): d in steps of 16,
    each step's 16 products (exact) and the running f32 sum added exactly
    and rounded toward zero.  On an H100 this model brings B5-B7's bf16
    outputs within f32 summation error of the plain versions on almost
    every entry, where a plain f32 matmul (another order, rounded to
    nearest) leaves operands a few ulps apart that round to other bf16
    values (scripts/torch_mma_sum_probe.py)."""
    a = a.to(torch.bfloat16).double()
    b = b.to(torch.bfloat16).double()
    acc = None
    for c0 in range(0, a.shape[-1], 16):
        x = a[..., c0:c0 + 16] @ b[..., c0:c0 + 16, :]
        acc = _round_toward_zero(x if acc is None else x + acc.double())
    return acc


def _d_dot(a, b, policy):
    """A tile matmul over d (q·kᵀ, do·vᵀ): under the bf16 policy in the
    tensor-core kernels' order (:func:`_mma_dot`), else ``kernel_dot``."""
    if getattr(policy, "matmul", "none") == "bf16":
        return _mma_dot(a, b)
    return kernel_dot(a, b, policy)


def _capped_logits(q, k, scale, softcap, policy):
    """(s, t): the logits before the mask, and the softcap's tanh (None
    without one)."""
    s = _d_dot(q, k.transpose(-1, -2), policy) * scale
    if not softcap:
        return s, None
    t = torch.tanh(s / torch.full_like(s, softcap))   # a true division, as the kernels'
    return softcap * t, t


def _lane_row_sum(p, width: int):
    """Row sums of a (..., n <= width) tile in the order of B5's f32 mode:
    each of 16 lanes adds the keys lane, lane + 16, ... in turn
    (zeros beyond n), then a butterfly over the lanes (xor 8, 4, 2, 1), so
    that the kernel and this plain version form the same l bit for bit."""
    x = torch.nn.functional.pad(p, (0, width - p.shape[-1])).unflatten(-1, (width // 16, 16))
    acc = x[..., 0, :]
    for j in range(1, width // 16):
        acc = acc + x[..., j, :]
    lane = torch.arange(16, device=p.device)
    for o in (8, 4, 2, 1):
        acc = acc + acc[..., lane ^ o]
    return acc[..., :1]


def _mma_row_sum(p, width: int):
    """Row sums of a (..., n <= width) tile in the order of B5's bf16 and
    int8 modes, whose tensor-core fragments (m16n8k16 f32 and m16n8k32 s32
    accumulators share their layout) give each of 4 lanes t the keys 8 j + 2 t
    and 8 j + 2 t + 1 of every 8-key group j: each lane adds its keys in
    that order, group by group (zeros beyond n), then a butterfly over the
    lanes (xor 1, 2), so that the kernel and this plain version form the
    same l from the same p."""
    x = torch.nn.functional.pad(p, (0, width - p.shape[-1])).unflatten(-1, (width // 8, 4, 2))
    acc = x[..., 0, :, 0]
    for j in range(width // 8):
        for e in range(1 if j == 0 else 0, 2):
            acc = acc + x[..., j, :, e]
    lane = torch.arange(4, device=p.device)
    for o in (1, 2):
        acc = acc + acc[..., lane ^ o]
    return acc[..., :1]


def flash_fwd_ref(q, k, v, *, scale: float = 1.0, causal: bool = True,
                  window: int = 0, softcap: float = 0.0, policy=None):
    """The plain version of the flash forward (B5) at the kernel's contract:
    ``(o, lse)``, o in q's dtype, lse (B, H, S) float32.

    It keeps the kernel's algorithm where it decides the numbers: the
    128-key tiles, skipped where no pair of the (64-row query tile, key
    tile) is visible, the online softmax (m, l, acc) with its alpha
    rescale and its row sums in the kernel's order (the tensor-core
    fragments' in the bf16 and int8 modes, the 16 lanes' in the f32
    mode), and each tile matmul
    under the policy: q·kᵀ (scales over d in the int8 mode, the MMA's
    order in the bf16 mode), then the
    unnormalized p = exp(s - m) of the tile times v (p rounded or quantized
    per row, v per column, over the tile's keys).  Every query row is
    carried at once."""
    B, S, H, d = q.shape
    T = k.shape[1]
    tq, tk = flash_tile("fwd", policy)
    row_sum = (_mma_row_sum if getattr(policy, "matmul", "none") in ("bf16", "int8")
               else _lane_row_sum)
    qh, kh, vh = _heads(q, k, v)
    rows = torch.arange(S, device=q.device)
    q0 = rows // tq * tq                              # each row's tile start
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, S, d, device=q.device)
    for k0 in range(0, T, tk):
        on = torch.ones_like(rows, dtype=torch.bool)  # _block_visible per row
        if causal:
            on &= k0 <= q0 + tq - 1
        if window:
            on &= k0 + tk - 1 >= q0 - window + 1
        if not bool(on.any()):
            continue
        ks = slice(k0, k0 + tk)
        s, _ = _capped_logits(qh, kh[:, :, ks], scale, softcap, policy)
        mask = _visible(S, T, causal, window, q.device)[:, ks]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        on = on[:, None]
        l = torch.where(on, alpha * l + row_sum(p, tk), l)
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
    the scale.  q·kᵀ and do·vᵀ take their int8 scales over d, so they run
    untiled (summed in the MMA's order in the bf16 mode).  The products whose scales run over a tile axis are summed
    tile by tile in the kernels' order, each quantized (int8) or rounded
    (bf16) on its own: ``dq`` over B6's key tiles, ``dk = dsᵀ q`` and
    ``dv = pᵀ do`` over the G query heads of each kv head and, inside,
    B7's query tiles.  A tile the kernels skip holds no visible pair: its
    p and ds are 0, and so is its product."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qh, kh, vh = _heads(q, k, v)
    doh = do.transpose(1, 2).float()
    s, t = _capped_logits(qh, kh, scale, softcap, policy)
    mask = _visible(S, T, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (_d_dot(doh, vh.transpose(-1, -2), policy) - delta[..., None])
    if softcap:
        ds = ds * (1 - t * t)
    ds = ds * scale
    _, tk = flash_tile("dq", policy)
    dq = 0.0
    for k0 in range(0, T, tk):
        ks = slice(k0, k0 + tk)
        dq = dq + kernel_dot(ds[..., ks], kh[:, :, ks], policy)

    def groups(x):                                    # (B, H, ...) -> (B, K, G, ...)
        return x.reshape(B, K, G, *x.shape[2:])

    tq, _ = flash_tile("dkv", policy)
    pg, dsg, qg, dog = groups(p), groups(ds), groups(qh), groups(doh)
    dk = dv = 0.0
    for g in range(G):
        for q0 in range(0, S, tq):
            qs = slice(q0, q0 + tq)
            dk = dk + kernel_dot(dsg[:, :, g, qs].transpose(-1, -2), qg[:, :, g, qs], policy)
            dv = dv + kernel_dot(pg[:, :, g, qs].transpose(-1, -2), dog[:, :, g, qs], policy)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


# The int8 backward's contraction over a 128-row tile (ds k, pᵀ do, dsᵀ q)
# in the order of the s8 MMA fragments (csrc/flash_attention.cu
# frag_perm): position p of each 16-group holds row FRAG_PERM[p] of the
# group.  A thread's s32 accumulators hold columns 2t, 2t+1, 8+2t, 9+2t of
# a 16-group, which it packs as A's bytes 4t..4t+3; B's rows follow.
FRAG_PERM = tuple(8 * ((i & 3) >> 1) + 2 * (i >> 2) + (i & 1) for i in range(16))
TILE_PERM = tuple(16 * (i // 16) + FRAG_PERM[i % 16] for i in range(128))
I8_TILE = 128
# d_head as the flash kernels pad it (csrc/flash_attention.cu instantiates
# DP 64, 128 and 256); nothing wider is taken
PADDED_D = (64, 128, 256)
MAX_D_HEAD = PADDED_D[-1]


def padded_d(d: int) -> int:
    """d_head as the flash kernels zero-pad it: the least of 64, 128 and 256
    that holds it.  Raises above 256: a narrower width would crop d."""
    for DP in PADDED_D:
        if 0 < d <= DP:
            return DP
    raise ValueError(f"the flash kernels take d_head 1 to {MAX_D_HEAD}, got {d}")


def flash_quant_bwd_ref(q, k, v, do) -> dict:
    """The plain version of the int8 backward's pre-pass
    (``flash_attention.quantize_bwd``), the same names, shapes and bytes:
    q, do, k and v quantized per row over d (zero-padded to DP =
    :func:`padded_d`) with their (B, heads, rows) scales, and q, do and k
    per column over each 128-row tile (rows past S or T zeros), stored (B,
    heads, tiles, DP, 128) with each 16-group of a tile's rows in FRAG_PERM order,
    their scales (B, heads, tiles, DP).  Each quantization is
    ``quant.quantize_int8``'s."""
    B, S, H, d = q.shape
    T = k.shape[1]
    DP = padded_d(d)
    F = torch.nn.functional

    def rows(x):
        x8, sc = quantize_int8(F.pad(x.float(), (0, DP - d)), axis=-1)
        return x8, sc[..., 0].transpose(1, 2).contiguous()

    def cols(x):
        R, heads = x.shape[1], x.shape[2]
        n = -(-R // I8_TILE)
        xp = F.pad(x.float(), (0, DP - d, 0, 0, 0, n * I8_TILE - R))
        x8, sc = quantize_int8(xp.reshape(B, n, I8_TILE, heads, DP), axis=2)
        x8 = x8.permute(0, 3, 1, 4, 2)[..., list(TILE_PERM)]
        return x8.contiguous(), sc[:, :, 0].permute(0, 2, 1, 3).contiguous()

    out = {}
    for name, x in (("q", q), ("do", do), ("k", k), ("v", v)):
        out[name + "8"], out["s" + name] = rows(x)
    for name, x in (("q", q), ("do", do), ("k", k)):
        out[name + "T8"], out["s" + name + "c"] = cols(x)
    return out


def flash_quant_fwd_ref(k, v) -> dict:
    """The plain version of the int8 forward's pre-pass
    (``flash_attention.quantize_fwd``), the same names, shapes and bytes: k
    per key over d (zero-padded to DP = :func:`padded_d`), ``k8`` (B, T,
    K, DP) with ``sk`` (B, K, T), :func:`flash_quant_bwd_ref`'s k8 and sk;
    v per column over each 128-key tile (keys past T zeros), ``vT8`` (B, K, nT,
    DP, 128) with each 16-group of a tile's keys in FRAG_PERM order, its
    scales ``svc`` (B, K, nT, DP).  Each quantization is
    ``quant.quantize_int8``'s."""
    B, T, K, d = k.shape
    DP = padded_d(d)
    F = torch.nn.functional
    k8, sk = quantize_int8(F.pad(k.float(), (0, DP - d)), axis=-1)
    n = -(-T // I8_TILE)
    vp = F.pad(v.float(), (0, DP - d, 0, 0, 0, n * I8_TILE - T))
    v8, sv = quantize_int8(vp.reshape(B, n, I8_TILE, K, DP), axis=2)
    return {"k8": k8, "sk": sk[..., 0].transpose(1, 2).contiguous(),
            "vT8": v8.permute(0, 3, 1, 4, 2)[..., list(TILE_PERM)].contiguous(),
            "svc": sv[:, :, 0].permute(0, 2, 1, 3).contiguous()}


def flash_fwd_i8_ref(ops, q, *, scale: float = 1.0, causal: bool = True, window: int = 0,
                     softcap: float = 0.0):
    """:func:`flash_fwd_ref` in the int8 mode restated on the forward
    pre-pass's operands (``ops``, as :func:`flash_quant_fwd_ref` makes them)
    and q: the plain version of B5 as the tensor-core kernel computes,
    ``(o, lse)``.  q quantized per row over d (as the kernel does at an
    item's set-up), s from the row-quantized bytes; on each visible 128-key
    tile p quantized per row over the tile's keys and permuted like vT8's
    rows (FRAG_PERM), so every int32 sum is the one :func:`flash_fwd_ref`
    forms, over the axis in another order."""
    B, S, H, d = q.shape
    k8 = ops["k8"]
    T, K, DP = k8.shape[1], k8.shape[2], k8.shape[3]
    if DP != padded_d(d):
        raise ValueError(f"k8 is padded to {DP}, q's d_head {d} to {padded_d(d)}")
    G = H // K
    F = torch.nn.functional
    perm = list(TILE_PERM)
    tq, tk = FLASH_TILES["fwd"]["int8"]

    def rep(x):                                        # (B, K, ...) -> (B, H, ...)
        return x.repeat_interleave(G, 1)

    q8, sq = quantize_int8(F.pad(q.float(), (0, DP - d)), axis=-1)
    s = _i8_dot(q8.transpose(1, 2), sq.transpose(1, 2), rep(k8.transpose(1, 2)).transpose(-1, -2),
                rep(ops["sk"])[..., None, :]) * scale
    if softcap:
        s = softcap * torch.tanh(s / torch.full_like(s, softcap))
    s = torch.where(_visible(S, T, causal, window, q.device), s, torch.full_like(s, NEG_INF))
    rows = torch.arange(S, device=q.device)
    q0 = rows // tq * tq
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, S, DP, device=q.device)
    for kt in range(-(-T // tk)):
        k0 = kt * tk
        on = torch.ones_like(rows, dtype=torch.bool)   # _block_visible per row
        if causal:
            on &= k0 <= q0 + tq - 1
        if window:
            on &= k0 + tk - 1 >= q0 - window + 1
        if not bool(on.any()):
            continue
        sc = s[..., k0:k0 + tk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        on = on[:, None]
        l = torch.where(on, alpha * l + _mma_row_sum(p, tk), l)
        p8, sp = quantize_int8(F.pad(p, (0, tk - p.shape[-1])), axis=-1)
        pv = _i8_dot(p8[..., perm], sp, rep(ops["vT8"][:, :, kt]).transpose(-1, -2),
                     rep(ops["svc"][:, :, kt])[..., None, :])
        acc = torch.where(on, acc * alpha + pv, acc)
        m = torch.where(on, m_new, m)
    lc = torch.clamp(l, min=1e-30)
    o = (acc[..., :d] / lc).transpose(1, 2).to(q.dtype)
    return o, (m + torch.log(lc))[..., 0]


def _i8_dot(a8, sa, b8, sb):
    """``a8 @ b8`` of int8 bytes quantized beforehand, summed exactly (a
    float64 matmul of the int8 values) and rescaled ``acc * sa * sb`` in
    f32: ``kernel_dot``'s int8 arithmetic after its quantization."""
    return (a8.double() @ b8.double()).float() * sa * sb


def flash_bwd_i8_ref(ops, lse, delta, *, d: int, scale: float = 1.0, causal: bool = True,
                     window: int = 0, softcap: float = 0.0):
    """:func:`flash_bwd_ref` in the int8 mode restated on the pre-pass's
    operands (``ops``, as :func:`flash_quant_bwd_ref` makes them; ``d`` the
    head dim before padding): the plain version of B6 and B7 as the
    tensor-core kernels compute, ``(dq, dk, dv)`` float32.  s and dp from
    the row-quantized bytes; ds k over each 128-key tile and pᵀ do, dsᵀ q
    over each 128-query tile (of each head of a group, in order) from the
    column-quantized tiles, p and ds quantized per row over the tile's
    columns and permuted like them (FRAG_PERM), so every int32 sum is the
    one :func:`flash_bwd_ref` forms, over the axis in another order."""
    q8, k8 = ops["q8"], ops["k8"]
    B, S, H, _ = q8.shape
    T, K = k8.shape[1], k8.shape[2]
    G = H // K
    F = torch.nn.functional
    perm = list(TILE_PERM)

    def rep(x):                                        # (B, K, ...) -> (B, H, ...)
        return x.repeat_interleave(G, 1)

    kh, vh = rep(k8.transpose(1, 2)), rep(ops["v8"].transpose(1, 2))
    sk, sv = rep(ops["sk"])[..., None, :], rep(ops["sv"])[..., None, :]
    s = _i8_dot(q8.transpose(1, 2), ops["sq"][..., None], kh.transpose(-1, -2), sk) * scale
    t = None
    if softcap:
        t = torch.tanh(s / torch.full_like(s, softcap))
        s = softcap * t
    mask = _visible(S, T, causal, window, q8.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = _i8_dot(ops["do8"].transpose(1, 2), ops["sdo"][..., None], vh.transpose(-1, -2), sv)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1 - t * t)
    ds = ds * scale

    nT, nS = -(-T // I8_TILE), -(-S // I8_TILE)
    dsk = F.pad(ds, (0, nT * I8_TILE - T))
    dq = 0.0
    for kt in range(nT):
        x8, sx = quantize_int8(dsk[..., kt * I8_TILE:(kt + 1) * I8_TILE], axis=-1)
        kT = rep(ops["kT8"][:, :, kt])                 # (B, H, DP, 128)
        dq = dq + _i8_dot(x8[..., perm], sx, kT.transpose(-1, -2),
                          rep(ops["skc"][:, :, kt])[..., None, :])

    def tiles(x):                                      # (B, H, S, T) -> (B, K, G, T, nS * 128)
        x = F.pad(x, (0, 0, 0, nS * I8_TILE - S)).transpose(-1, -2)
        return x.reshape(B, K, G, T, nS * I8_TILE)

    pq, dsq = tiles(p), tiles(ds)
    dk = dv = 0.0
    for g in range(G):
        heads = torch.arange(K, device=q8.device) * G + g
        for qt in range(nS):
            qs = slice(qt * I8_TILE, (qt + 1) * I8_TILE)
            p8, sp = quantize_int8(pq[:, :, g, :, qs], axis=-1)
            d8, sd = quantize_int8(dsq[:, :, g, :, qs], axis=-1)
            dv = dv + _i8_dot(p8[..., perm], sp, ops["doT8"][:, heads, qt].transpose(-1, -2),
                              ops["sdoc"][:, heads, qt][..., None, :])
            dk = dk + _i8_dot(d8[..., perm], sd, ops["qT8"][:, heads, qt].transpose(-1, -2),
                              ops["sqc"][:, heads, qt][..., None, :])
    return (dq[..., :d].transpose(1, 2), dk[..., :d].transpose(1, 2),
            dv[..., :d].transpose(1, 2))


def _gather_kv(k_pages, v_pages, tab, k_scale, v_scale):
    """Gather pages to f32 (B, C, P, K, d) bands, dequantizing int8 pools
    with their per-page-per-head scales when given (int8 · scale in f32, the
    kernels' arithmetic as they stage a page)."""
    k = k_pages[tab].float()
    v = v_pages[tab].float()
    if k_scale is not None:
        k = k * k_scale[tab][:, :, None, :, None]
        v = v * v_scale[tab][:, :, None, :, None]
    return k, v


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
    k_scale=None,               # (N, K) f32 per-page-per-head scales (int8 pools)
    v_scale=None,
) -> torch.Tensor:
    """Single-query attention over a paged KV cache (the flash-decode oracle).

    Gathers each slot's pages into a contiguous (C*P) band and masks by the
    *stored* token positions: an entry is visible iff pos >= 0, pos <= q_pos
    and (windowed) q_pos - pos < window.  Fully-masked rows (inactive slots,
    q_pos = -1) return exact zeros.  With ``k_scale``/``v_scale`` the pools
    hold int8 bytes, dequantized to f32 after the gather.
    """
    B, H, d = q.shape
    N, P, K, _ = k_pages.shape
    C = page_table.shape[1]
    G = H // K
    tab = page_table.long().clamp(0, N - 1)
    k, v = _gather_kv(k_pages, v_pages, tab, k_scale, v_scale)
    k = k.reshape(B, C * P, K, d)
    v = v.reshape(B, C * P, K, d)
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


def _merge_states(states):
    """Merge (m, l, acc) online-softmax states in the order given, as B8
    merges its warps and blocks and B9 its blocks (any leading shape of m
    and l, acc with one more axis): the largest m first, then each state's l
    and acc weighed by exp(m_i - m) in turn; a state that saw no visible
    entry (l = 0) weighs 0, never exp(0) = 1."""
    m = states[0][0]
    for mi, _, _ in states[1:]:
        m = torch.maximum(m, mi)
    l = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        w = torch.where(li > 0, torch.exp(mi - m), torch.zeros_like(li))
        l = l + w * li
        acc = acc + w[..., None] * ai
    return m, l, acc


def decode_attention_split_ref(
    q: torch.Tensor,            # (B, H, d) — one query per decode slot
    k_pages: torch.Tensor,      # (N, P, K, d) — paged KV pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32 token positions; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids per slot
    q_pos: torch.Tensor,        # (B,) int32 query positions; -1 = inactive slot
    *,
    scale,
    splits: int,
    warps: int,
    window: int = 0,
    softcap: float = 0.0,
    k_scale=None,               # (N, K) f32 per-page-per-head scales (int8 pools)
    v_scale=None,
) -> torch.Tensor:
    """:func:`decode_attention_ref` computed the way B8 splits it (a test
    oracle, not on any path): a slot's live pages, n_live = min(C, q_pos //
    P + 1), are dealt to ``splits`` x ``warps`` warps, page j to cluster warp
    j mod (splits x warps), where warp w of block r is cluster warp
    w x splits + r.  Each warp keeps its own (m, l, acc) over its pages, one
    page at a time (the kernel goes by row steps of a page: the same
    function up to rounding); each block merges its warps in order, then
    the blocks merge in rank order (:func:`_merge_states`), and the guarded
    divide gives exact zeros where nothing was visible."""
    B, H, d = q.shape
    N, P, K, _ = k_pages.shape
    C = page_table.shape[1]
    G = H // K
    NW = splits * warps
    tab = page_table.long().clamp(0, N - 1)
    k, v = _gather_kv(k_pages, v_pages, tab, k_scale, v_scale)   # (B, C, P, K, d)
    pos = pos_pages[tab]                                          # (B, C, P)
    qg = q.reshape(B, K, G, d).float()
    out = torch.zeros(B, K, G, d)
    for b in range(B):
        qp = int(q_pos[b])
        if qp < 0:
            continue
        empty = (torch.full((K, G), NEG_INF), torch.zeros(K, G), torch.zeros(K, G, d))
        state = [empty] * NW
        for j in range(min(C, qp // P + 1)):
            m, l, acc = state[j % NW]
            s = torch.einsum("kgd,pkd->kgp", qg[b], k[b, j]) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            t = pos[b, j]
            vis = (t >= 0) & (t <= qp)
            if window:
                vis &= (qp - t) < window
            s = torch.where(vis, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(vis, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            state[j % NW] = (m_new, alpha * l + p.sum(-1),
                             acc * alpha[..., None] + torch.einsum("kgp,pkd->kgd", p, v[b, j]))
        blocks = [_merge_states([state[w * splits + r] for w in range(warps)])
                  for r in range(splits)]
        _, l, acc = _merge_states(blocks)
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, d).to(q.dtype)


def decode_attention_multi_ref(
    q: torch.Tensor,            # (B, T, H, d) — T queries per decode slot
    k_pages: torch.Tensor,      # (N, P, K, d) — paged KV pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32 token positions; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids per slot
    q_pos: torch.Tensor,        # (B, T) int32 per-query positions; -1 = masked
    *,
    scale,
    window: int = 0,
    softcap: float = 0.0,
    k_scale=None,               # (N, K) f32 per-page-per-head scales (int8 pools)
    v_scale=None,
    acc_dtype=torch.float32,    # the float type the products and sums run in
) -> torch.Tensor:
    """Multi-query attention over a paged KV cache (the chunked-prefill and
    speculative-verify oracle); int8 pools as in :func:`decode_attention_ref`.

    The visibility rule of :func:`decode_attention_ref`, per query row: an
    entry is visible to row t iff pos >= 0, pos <= q_pos[:, t] and
    (windowed) q_pos[:, t] - pos < window.  Rows with q_pos = -1 give exact
    zeros.  The engine writes the chunk into the pages before attending, so
    the same rule gives causality within the chunk.  ``acc_dtype`` float64
    runs the same function past f32's rounding (the pages dequantized in
    f32 first, as the kernel does): the card's checks measure both B9 and
    the f32 plain version against it, and hold B9 to it only where the f32
    plain version misses the tier and is the farther of the two (d_head 256
    over int8 pools, outputs up to ~10, brings the f32 logits' own rounding
    near the tier).
    """
    B, T, H, d = q.shape
    N, P, K, _ = k_pages.shape
    C = page_table.shape[1]
    G = H // K
    tab = page_table.long().clamp(0, N - 1)
    k, v = _gather_kv(k_pages, v_pages, tab, k_scale, v_scale)
    k = k.reshape(B, C * P, K, d).to(acc_dtype)
    v = v.reshape(B, C * P, K, d).to(acc_dtype)
    pos = pos_pages[tab].reshape(B, C * P)[:, None, :]      # (B, 1, CP)
    qp = q_pos[:, :, None]                                  # (B, T, 1)
    mask = (pos >= 0) & (pos <= qp)
    if window:
        mask &= (qp - pos) < window
    qg = q.reshape(B, T, K, G, d).float().to(acc_dtype)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    m = mask[:, None, None]                                 # (B, 1, 1, T, CP)
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(B, T, H, d).to(q.dtype)


def decode_attention_multi_split_ref(
    q: torch.Tensor,            # (B, T, H, d) — T queries per decode slot
    k_pages: torch.Tensor,      # (N, P, K, d) — paged KV pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32 token positions; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids per slot
    q_pos: torch.Tensor,        # (B, T) int32 per-query positions; -1 = masked
    *,
    scale,
    tq: int,
    splits: int,
    window: int = 0,
    softcap: float = 0.0,
    k_scale=None,               # (N, K) f32 per-page-per-head scales (int8 pools)
    v_scale=None,
) -> torch.Tensor:
    """:func:`decode_attention_multi_ref` computed the way B9 splits it (a
    test oracle, not on any path): the T queries in tiles of ``tq``; a
    tile's live pages, n_live = min(C, max q_pos of the tile // P + 1),
    dealt to ``splits`` blocks, page j to block j mod splits.  Each block
    keeps one online-softmax state (m, l, acc) per (kv head, query, head of
    the group) over its pages, one page at a time (the kernel goes by steps
    of 64 tokens: the same function up to rounding); the blocks merge in
    rank order (:func:`_merge_states`, over (K, tq, G) rows), and the
    guarded divide gives exact zeros where nothing was visible."""
    B, T, H, d = q.shape
    N, P, K, _ = k_pages.shape
    C = page_table.shape[1]
    G = H // K
    tab = page_table.long().clamp(0, N - 1)
    k, v = _gather_kv(k_pages, v_pages, tab, k_scale, v_scale)   # (B, C, P, K, d)
    pos = pos_pages[tab]                                          # (B, C, P)
    qg = q.reshape(B, T, K, G, d).float().permute(0, 2, 1, 3, 4)  # (B, K, T, G, d)
    out = torch.zeros(B, K, T, G, d)
    for b in range(B):
        for t0 in range(0, T, tq):
            qp = q_pos[b, t0:t0 + tq].long()                      # (nt,)
            nt = qp.shape[0]
            qmax = int(qp.max())
            n_live = min(C, qmax // P + 1) if qmax >= 0 else 0
            empty = (torch.full((K, nt, G), NEG_INF), torch.zeros(K, nt, G),
                     torch.zeros(K, nt, G, d))
            state = [empty] * splits
            for j in range(n_live):
                m, l, acc = state[j % splits]
                s = torch.einsum("kigd,pkd->kigp", qg[b, :, t0:t0 + nt], k[b, j]) * scale
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                t = pos[b, j][None, :]                            # (1, P)
                vis = (t >= 0) & (t <= qp[:, None])               # (nt, P)
                if window:
                    vis &= (qp[:, None] - t) < window
                vis = vis[None, :, None, :]
                s = torch.where(vis, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.where(vis, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
                alpha = torch.exp(m - m_new)
                state[j % splits] = (m_new, alpha * l + p.sum(-1), acc * alpha[..., None]
                                     + torch.einsum("kigp,pkd->kigd", p, v[b, j]))
            _, l, acc = _merge_states(state)
            out[b, :, t0:t0 + nt] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, T, H, d).to(q.dtype)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in B1's accumulation type: f32, or f64 for a float64 tensor (a
    float64 forward, the reference that rounding is measured against)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _gain_rows(gain: torch.Tensor, D: int) -> torch.Tensor:
    """``1 + gain`` against rows laid out (G, rows / G, D): (D,) for a (D,)
    gain, (G, 1, D) for a gain per group."""
    w = 1.0 + _acc(gain)
    return w if gain.ndim == 1 else w.reshape(-1, 1, D)


def rmsnorm_ref(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """B1's plain version; ``gain`` (D,), or (G, D) over x's rows in G equal
    contiguous groups (group i's rows take gain row i)."""
    xa = _acc(x)
    var = torch.mean(xa * xa, dim=-1, keepdim=True)
    y = xa * torch.rsqrt(var + eps)
    if gain.ndim == 2:
        D = x.shape[-1]
        return (y.reshape(gain.shape[0], -1, D) * _gain_rows(gain, D)).reshape(
            x.shape).to(x.dtype)
    return (y * (1.0 + _acc(gain))).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients of :func:`rmsnorm_ref`: ``(dx, dgain)``, recomputing r
    from x.  ``dx = r (1 + g) dy - x r^3 / D * sum_j dy_j (1 + g_j) x_j``,
    ``dgain = sum_rows dy * x * r``; dx in x's dtype, dgain float32 shaped
    like gain (a (G, D) gain: row i summed over group i's rows)."""
    D = x.shape[-1]
    lead = (-1, D) if gain.ndim == 1 else (gain.shape[0], -1, D)
    x32 = x.float().reshape(lead)
    dy32 = dy.float().reshape(lead)
    w = _gain_rows(gain, D)
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    dyw = dy32 * w
    rowdot = torch.sum(dyw * x32, dim=-1, keepdim=True)
    dx = r * dyw - x32 * (r * r * r / D) * rowdot
    dgain = torch.sum(dy32 * x32 * r, dim=-2)
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
