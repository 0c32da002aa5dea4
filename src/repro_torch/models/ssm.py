"""Mamba-2 SSD (state-space duality) mixer block.

The port of ``repro.models.ssm``: the chunked SSD algorithm (Dao & Gu 2024,
arXiv:2405.21060).  The sequence is split into chunks of Q positions;
within a chunk the terms are masked attention-like matmuls, across chunks
the state is carried by the recurrence ``H_c = exp(a_sum_c) H_{c-1} + S_c``,
which the port runs as a loop over the chunks where the reference runs an
associative scan (the values agree up to f32 summation order).  Everything
is out of place, so a sweep can ``torch.func.vmap`` the block.

muP classification, as in the reference:
  w_x / w_z / w_dt / out_proj : hidden matrices (width -> width)
  w_B / w_C                   : width -> ssm_state (finite)  => OUTPUT-like
                                (their 1/width multiplier is the SSM analogue
                                of 1/d attention: C.h.B inner products stay
                                Theta(1) with width)
  A_log / dt_bias / D_skip / norm gain : vector-like (constant LR)

The SSD mixer reaches no kernel: the scan, the causal conv and the gated
norm are plain PyTorch, as they are plain ``jnp`` in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.meta import ParamMeta
from repro_torch.core.parametrization import Role
from repro_torch.models.layers import apply_w, bias_meta, dense_meta, softplus, wmeta


def ssd_heads(cfg) -> Tuple[int, int]:
    """(n_heads, head_dim) of the SSD mixer."""
    nh = cfg.ssm_n_heads or cfg.d_inner // cfg.ssm_head_dim
    return nh, cfg.d_inner // nh


def ssd_meta(cfg, name: str) -> Dict[str, ParamMeta]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, _ = ssd_heads(cfg)
    bd = cfg.base_d_model
    bdi = int(round(di * bd / d))
    bnh = max(int(round(nh * bd / d)), 1)
    cw = cfg.conv_width
    return {
        "w_x": dense_meta(f"{name}.w_x", d, di, bd, bdi),
        "w_z": dense_meta(f"{name}.w_z", d, di, bd, bdi),
        "w_B": dense_meta(f"{name}.w_B", d, n, bd, n, out_is_width=False),
        "w_C": dense_meta(f"{name}.w_C", d, n, bd, n, out_is_width=False),
        "w_dt": dense_meta(f"{name}.w_dt", d, nh, bd, bnh),
        "dt_bias": bias_meta(f"{name}.dt_bias", nh, bnh),
        "A_log": wmeta(
            f"{name}.A_log", (nh,), (bnh,), width_axes=(0,), fan_in_axes=(0,),
            fan_out_axes=(0,), init="normal", role=Role.INPUT,
            owns_scale=False,  # applied raw (exp'd decay, no mult)
        ),
        "D_skip": wmeta(
            f"{name}.D_skip", (nh,), (bnh,), width_axes=(0,), fan_in_axes=(0,),
            fan_out_axes=(0,), init="ones", role=Role.INPUT,
            owns_scale=False,  # applied raw (skip gain, no mult)
        ),
        "conv_w": wmeta(
            f"{name}.conv_w", (cw, di + 2 * n), (cw, bdi + 2 * n), width_axes=(1,),
            fan_in_axes=(0,), fan_out_axes=(1,),
            owns_scale=False,  # applied raw inside the causal conv
        ),
        "conv_b": bias_meta(f"{name}.conv_b", di + 2 * n, bdi + 2 * n),
        "norm_gain": bias_meta(f"{name}.norm_gain", di, bdi),
        "out_proj": dense_meta(f"{name}.out_proj", di, d, bdi, bd),
    }


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a (..., Q) -> (..., Q, Q) with out[i, j] = sum_{k=j+1..i} log_a[k],
    -inf for j > i (strictly causal cumulative decay).  A difference of
    cumulative sums, as in the reference, so the decays round as its do."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=log_a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def _causal_conv(u, conv_w, conv_b, state=None):
    """Depthwise causal conv of width cw over u (B, S, C), then SiLU; the
    last cw - 1 inputs (with ``state``, the previous ones, in front) are
    the new state."""
    cw = conv_w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    y = full[:, 0:S] * conv_w[0].to(u.dtype)
    for i in range(1, cw):
        y = y + full[:, i:i + S] * conv_w[i].to(u.dtype)
    y = F.silu(y + conv_b.to(u.dtype))
    new_state = full[:, -(cw - 1):] if cw > 1 else pad
    return y, new_state


def ssd_chunked(
    x: torch.Tensor,        # (B, S, nh, hd) inputs (dt not applied yet)
    dt: torch.Tensor,       # (B, S, nh) softplus'd step sizes
    A: torch.Tensor,        # (nh,) negative decay rates
    Bm: torch.Tensor,       # (B, S, n)
    Cm: torch.Tensor,       # (B, S, n)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, nh, hd, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, nh, hd), h_last (B, nh, hd, n)), in f32 (f64 for
    float64 inputs).  A sequence longer than one chunk must be a whole
    number of chunks: the reference has no padding, and neither has this."""
    Bsz, S, nh, hd = x.shape
    n = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence length S={S} is not a multiple of "
                         f"the chunk Q={Q}")
    nc = S // Q
    acc = torch.promote_types(x.dtype, torch.float32)
    x, dt, Bm, Cm, A = (t.to(acc) for t in (x, dt, Bm, Cm, A))

    log_a = dt * A[None, None, :]                         # (B, S, nh) <= 0
    u = x * dt[..., None]                                 # dt-scaled input
    xc = u.reshape(Bsz, nc, Q, nh, hd)
    ac = log_a.reshape(Bsz, nc, Q, nh)
    bc = Bm.reshape(Bsz, nc, Q, n)
    cc = Cm.reshape(Bsz, nc, Q, n)

    # ---- intra-chunk (attention-like, masked by decay) -------------------
    # masked before the exp: above the diagonal the difference is >= 0
    L = torch.exp(_segsum(ac.transpose(2, 3)))            # (B, nc, nh, Q, Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)      # (B, nc, Q, Q)
    # in two contractions: never a (B, nc, nh, Q, Q, hd) intermediate
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * L, xc)

    # ---- chunk states -----------------------------------------------------
    cs = torch.cumsum(ac, dim=2)                          # (B, nc, Q, nh)
    a_sum = cs[:, :, -1]                                  # (B, nc, nh)
    decay_to_end = torch.exp(a_sum[:, :, None, :] - cs)
    states = torch.einsum("bcjn,bcjhp->bchpn", bc, xc * decay_to_end[..., None])

    # ---- inter-chunk recurrence: H_c = exp(a_sum_c) H_{c-1} + S_c ----------
    H = (torch.zeros((Bsz, nh, hd, n), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    gam = torch.exp(a_sum)                                # (B, nc, nh)
    h_prev = []
    for c in range(nc):
        h_prev.append(H)                                  # state BEFORE chunk c
        H = gam[:, c, :, None, None] * H + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (B, nc, nh, hd, n)

    # ---- inter-chunk output ----------------------------------------------
    y_off = torch.einsum("bcin,bchpn->bcihp", cc, h_prev) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, nh, hd)
    return y, H


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    """Single token: x (B, 1, nh, hd), dt (B, 1, nh), Bm/Cm (B, 1, n), h (B,
    nh, hd, n).  Returns (y (B, 1, nh, hd), the new h)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x, dt, Bm, Cm, h, A = (t.to(acc) for t in (x, dt, Bm, Cm, h, A))
    a = torch.exp(dt[:, 0] * A[None])                     # (B, nh)
    u = x[:, 0] * dt[:, 0, :, None]                       # (B, nh, hd)
    h_new = a[..., None, None] * h + torch.einsum("bn,bhp->bhpn", Bm[:, 0], u)
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h_new)
    return y[:, None], h_new


def ssd_block(
    cfg, params, meta, x, parametrization, cache=None, mode: str = "train",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The full Mamba-2 mixer over pre-normed x (B, S, D).  Returns (out,
    new_cache): ``{"h", "conv"}`` in prefill and decode, None in train."""
    di, n = cfg.d_inner, cfg.ssm_state
    nh, hd = ssd_heads(cfg)
    p13n = parametrization

    xs = apply_w(x, params["w_x"], meta["w_x"], p13n, "bsd,di->bsi")
    z = apply_w(x, params["w_z"], meta["w_z"], p13n, "bsd,di->bsi")
    Bm = apply_w(x, params["w_B"], meta["w_B"], p13n, "bsd,dn->bsn")
    Cm = apply_w(x, params["w_C"], meta["w_C"], p13n, "bsd,dn->bsn")
    dt_raw = apply_w(x, params["w_dt"], meta["w_dt"], p13n, "bsd,dh->bsh")
    acc = torch.promote_types(x.dtype, torch.float32)
    dt = softplus(dt_raw.to(acc) + params["dt_bias"].to(acc))
    A = -torch.exp(params["A_log"].to(acc))               # (nh,) < 0

    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_state = None if cache is None else cache["conv"]
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                      conv_state)
    xs, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)
    xh = xs.reshape(*xs.shape[:2], nh, hd)

    if mode == "decode":
        y, h_last = ssd_decode_step(xh, dt, A, Bm, Cm, cache["h"])
        new_cache = {"h": h_last, "conv": new_conv}
    else:
        h0 = cache.get("h") if cache else None
        y, h_last = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, h0=h0)
        new_cache = {"h": h_last, "conv": new_conv} if mode == "prefill" else None

    y = y + params["D_skip"].to(acc)[None, None, :, None] * xh.to(acc)
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    g = (y * F.silu(z)).to(acc)
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = (g * torch.rsqrt(var + 1e-6) * (1.0 + params["norm_gain"].to(acc))).to(x.dtype)
    out = apply_w(g, params["out_proj"], meta["out_proj"], p13n, "bsi,id->bsd")
    return out, new_cache
