"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro.models.rglru``.  Temporal mixing:

    y = W_out( conv_branch(x) * gelu(W_gate_in x) )
    conv_branch = RG-LRU( causal_conv1d( W_in x ) )

RG-LRU recurrence (per channel):

    r_t = sigmoid(W_a u_t + b_a)               # recurrence gate
    i_t = sigmoid(W_x u_t + b_x)               # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

A full sequence runs the recurrence as a log-depth doubling scan, the
reference's ``associative_scan`` in plain PyTorch (the values agree up to
f32 summation order); decode is the single-step update.  Everything is out
of place, so a sweep can ``torch.func.vmap`` the block.

muP classification, as in the reference: W_in / W_gate_in / W_out and the
gate matrices are hidden matrices; Lambda and all biases are vector-like
(constant Adam LR).

The RG-LRU mixer reaches no kernel: the conv, the gates and the scan are
plain PyTorch, as they are plain ``jnp`` in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.meta import ParamMeta
from repro_torch.models.layers import apply_w, bias_meta, dense_meta, softplus, wmeta

_C = 8.0


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_meta(cfg, name: str) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    w = lru_width(cfg)
    bd = cfg.base_d_model
    bw = int(round(w * bd / d))
    cw = cfg.conv_width
    return {
        "w_in": dense_meta(f"{name}.w_in", d, w, bd, bw),
        "w_gate_in": dense_meta(f"{name}.w_gate_in", d, w, bd, bw),
        "w_out": dense_meta(f"{name}.w_out", w, d, bw, bd),
        "conv_w": wmeta(
            f"{name}.conv_w", (cw, w), (cw, bw), width_axes=(1,),
            fan_in_axes=(0,), fan_out_axes=(1,),
            owns_scale=False,  # applied raw inside the causal conv
        ),
        "conv_b": bias_meta(f"{name}.conv_b", w, bw),
        # the gates: full hidden matrices, as in the reference (Griffin's
        # are block-diagonal; dense is the width-general, µP-classifiable case)
        "w_a": dense_meta(f"{name}.w_a", w, w, bw, bw),
        "w_x": dense_meta(f"{name}.w_x", w, w, bw, bw),
        "b_a": bias_meta(f"{name}.b_a", w, bw),
        "b_x": bias_meta(f"{name}.b_x", w, bw),
        "lam": wmeta(
            f"{name}.lam", (w,), (bw,), width_axes=(0,), fan_in_axes=(0,),
            fan_out_axes=(0,), init="normal", init_scale=1.0,
            owns_scale=False,  # applied raw (softplus'd decay, no mult)
        ),
    }


def _causal_conv(u, conv_w, conv_b, state=None):
    """Depthwise causal conv of width cw over u (B, S, W), no activation.
    Returns (y, new_state): the state holds the last cw - 1 inputs (with
    ``state``, the previous ones, in front).  The taps are summed as the
    reference's Python ``sum`` sums them: from 0, tap 0 first, then the
    bias."""
    cw = conv_w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                    # (B, S + cw - 1, W)
    S = u.shape[1]
    y = 0
    for i in range(cw):
        y = y + full[:, i:i + S] * conv_w[i].to(u.dtype)
    y = y + conv_b.to(u.dtype)
    new_state = full[:, -(cw - 1):] if cw > 1 else pad
    return y, new_state


def _gates(params, meta, u, parametrization):
    """(a, gated input) of the recurrence, in f32 (f64 for float64 u):
    r and i in u's dtype, the decay and its complement from log a, as the
    reference rounds them."""
    acc = torch.promote_types(u.dtype, torch.float32)
    r = torch.sigmoid(
        apply_w(u, params["w_a"], meta["w_a"], parametrization, "bsw,wv->bsv")
        + params["b_a"].to(u.dtype))
    i = torch.sigmoid(
        apply_w(u, params["w_x"], meta["w_x"], parametrization, "bsw,wv->bsv")
        + params["b_x"].to(u.dtype))
    log_a = -_C * softplus(params["lam"].to(acc)) * r.to(acc)
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
             * (i.to(acc) * u.to(acc)))
    return a, gated


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1, in log2 S
    steps: after the step of offset k, (A, B)[t] composes the steps
    t - 2k + 1..t, (A, B)[t] <- (A[t] A[t-k], A[t] B[t-k] + B[t])."""
    S = a.shape[1]
    k = 1
    while k < S:
        a, b = (torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1),
                torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1))
        k *= 2
    return b


def rglru_scan(params, meta, u, parametrization, h0=None):
    """Full-sequence RG-LRU.  u (B, S, W) -> (y in u's dtype, h_last f32)."""
    a, b = _gates(params, meta, u, parametrization)      # (B, S, W)
    if h0 is not None:
        # the initial state folded in as a prepended step (1, h0), as the
        # reference folds it
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.to(b.dtype)[:, None], b], dim=1)
    h = _doubling_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(u.dtype), h[:, -1]


def rglru_step(params, meta, u, h, parametrization):
    """Single-token decode.  u (B, 1, W), h (B, W) -> (y (B, 1, W), h')."""
    a, b = _gates(params, meta, u, parametrization)
    h_new = a[:, 0] * h.to(a.dtype) + b[:, 0]
    return h_new[:, None].to(u.dtype), h_new


def init_rglru_cache(cfg, batch: int, dtype=torch.float32, device=None):
    w = lru_width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


def rglru_block(
    cfg, params, meta, x, parametrization, cache=None, mode: str = "train",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Griffin temporal-mixing block over pre-normed x (B, S, D).
    Returns (out, new_cache): ``{"h", "conv"}`` in prefill and decode, None
    in train.  The gate is the tanh-approximated gelu whatever ``cfg.act``
    says, as in the reference."""
    p13n = parametrization
    u = apply_w(x, params["w_in"], meta["w_in"], p13n, "bsd,dw->bsw")
    g = apply_w(x, params["w_gate_in"], meta["w_gate_in"], p13n, "bsd,dw->bsw")
    conv_state = None if cache is None else cache["conv"]
    u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"], conv_state)
    if mode == "decode":
        y, h_last = rglru_step(params, meta, u, cache["h"], p13n)
        new_cache = {"h": h_last, "conv": new_conv}
    else:
        h0 = cache.get("h") if cache else None
        y, h_last = rglru_scan(params, meta, u, p13n, h0=h0)
        new_cache = {"h": h_last, "conv": new_conv} if mode == "prefill" else None
    y = y * F.gelu(g, approximate="tanh")
    out = apply_w(y, params["w_out"], meta["w_out"], p13n, "bsw,wd->bsd")
    return out, new_cache
