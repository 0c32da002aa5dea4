"""Mixture-of-Experts FFN: token-choice top-k with per-sequence capacity.

The port's counterpart of ``repro.models.moe``, with the same semantics:

  - routing in f32 through ``apply_w`` (the router owns its multiplier),
    softmax, top-k with ties to the lower expert index (as
    ``jax.lax.top_k``), the k gates renormalised when k > 1;
  - dispatch per sequence: a fixed capacity C = max(8, min(ceil(k S cf /
    E), S k)) over each call's own S, slots ranked by a cumsum over the
    flattened S k slots (token-major, then choice); a slot past its
    expert's capacity is dropped: it reads the zero sentinel row and adds
    nothing (the token falls back to the residual stream);
  - the experts' products as batched matmuls over (E, B C, .) in
    ``x.dtype``, with the expert weights used raw (``owns_scale=False``)
    and never copied when their dtype is ``x``'s;
  - the combine a scatter-add into (B, S + 1, D), the sentinel row last.

muP: expert kernels are hidden matrices; the router maps width ->
n_experts (finite), so it is output-like: its logits take the
1/width_mult multiplier, keeping routing width-stable (router temperature
muTransfers).  The reference computes the expert products outside any
Pallas kernel, and so does the port (cuBLAS through ``torch.matmul``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.meta import ParamMeta
from repro_torch.models.layers import apply_w, wmeta


def moe_meta(cfg, name: str) -> Dict[str, ParamMeta]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    bd, bf = cfg.base_d_model, cfg.base_d_ff
    glu = cfg.act.endswith("_glu")
    return {
        # width -> n_experts: output-like
        "router": wmeta(f"{name}.router", (d, e), (bd, e), width_axes=(0,),
                        fan_in_axes=(0,), fan_out_axes=(1,)),
        "wi": wmeta(
            f"{name}.wi", (e, d, (2 if glu else 1) * f),
            (e, bd, (2 if glu else 1) * bf),
            width_axes=(1, 2), fan_in_axes=(1,), fan_out_axes=(2,),
            owns_scale=False,  # applied raw in the capacity path (no mult)
        ),
        "wo": wmeta(
            f"{name}.wo", (e, f, d), (e, bf, bd),
            width_axes=(1, 2), fan_in_axes=(1,), fan_out_axes=(2,),
            owns_scale=False,  # applied raw in the capacity path (no mult)
        ),
    }


def _capacity(cfg, seq_len: int) -> int:
    c = int(math.ceil(cfg.top_k * seq_len * cfg.capacity_factor / cfg.n_experts))
    return max(8, min(c, seq_len * cfg.top_k))


def route(cfg, params, meta, x: torch.Tensor, parametrization
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(router logits (B, S, E) f32, gates (B, S, k), expert ids (B, S, k)
    int64).  The experts are the k most probable in descending order, ties
    to the lower index (a stable sort: ``torch.topk`` promises no order on
    ties, ``jax.lax.top_k`` takes the lower index)."""
    logits = apply_w(x.float(), params["router"].float(), meta["router"],
                     parametrization, "bsd,de->bse")
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :cfg.top_k]
    gate = probs.gather(-1, idx)
    if cfg.top_k > 1:
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    return logits, gate, idx


def dispatch(expert_idx: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """The dispatch table d_idx (B, E, C): the flattened slot t = s k + j
    that fills expert e's c-th place, or the sentinel T = S k where none
    does.  Ranks come from a cumsum over the T slots, token-major then
    choice; a slot ranked at or past C is dropped."""
    B, S, k = expert_idx.shape
    T, E, C = S * k, n_experts, capacity
    flat_e = expert_idx.reshape(B, T)
    rank = F.one_hot(flat_e, E).cumsum(dim=1).gather(-1, flat_e[..., None])[..., 0] - 1
    keep = rank < C
    # kept slots land on distinct (e, c) places; dropped ones on one spare
    # place past the table, cut off below
    dest = torch.where(keep, flat_e * C + rank, E * C)
    d_idx = torch.full((B, E * C + 1), T, dtype=torch.long, device=expert_idx.device)
    t_ix = torch.arange(T, device=expert_idx.device).expand(B, T)
    # out of place: under torch.func.vmap the fresh table is unbatched and
    # ``dest`` batched, which an in-place scatter_ refuses
    d_idx = d_idx.scatter(1, dest, t_ix)
    return d_idx[:, :E * C].reshape(B, E, C)


def moe_ffn(
    cfg,
    params: Dict[str, torch.Tensor],
    meta: Dict[str, ParamMeta],
    x: torch.Tensor,                  # (B, S, D)
    parametrization,
    act_fn,
) -> torch.Tensor:
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    T = S * k

    _, gate, expert_idx = route(cfg, params, meta, x, parametrization)
    d_idx = dispatch(expert_idx, E, C)                         # (B, E, C)
    # rows of the flattened (B (S + 1), D) input, expert-major (E, B C); a
    # sentinel slot reads the zero row S of its sequence
    tok = torch.clamp(d_idx // k, max=S)
    b_ix = torch.arange(B, device=x.device)[:, None, None]
    rows = (b_ix * (S + 1) + tok).permute(1, 0, 2).reshape(E, B * C)
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1).reshape(B * (S + 1), D)
    xs = x_pad[rows]                                           # (E, B C, D)

    # expert weights raw, in x's dtype (no copy when they already are)
    h = torch.matmul(xs, params["wi"].to(x.dtype))             # (E, B C, (2) F)
    if cfg.act.endswith("_glu"):
        g, u = torch.chunk(h, 2, dim=-1)
        h = act_fn(g) * u
    else:
        h = act_fn(h)
    ys = torch.matmul(h, params["wo"].to(x.dtype))             # (E, B C, D)

    g_pad = torch.cat([gate.reshape(B, T), gate.new_zeros(B, 1)], dim=1)
    slot_gate = g_pad.gather(1, d_idx.reshape(B, E * C)).reshape(B, E, C)
    ys = ys * slot_gate.permute(1, 0, 2).reshape(E, B * C, 1).to(ys.dtype)
    # each token gets at most k contributions, each added to an exact 0:
    # for k <= 2 any order of the adds gives the same bits (a + b = b + a),
    # so index_add's unordered adds on the card are deterministic; a
    # larger k would need an ordered sum.  Out of place, as in dispatch
    out = ys.new_zeros(B * (S + 1), D).index_add(
        0, rows.reshape(-1), ys.reshape(E * B * C, D))
    return out.reshape(B, S + 1, D)[:, :S].to(x.dtype)


def aux_load_balance_loss(
    logits: torch.Tensor, expert_idx: torch.Tensor, n_experts: int
) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (exposed for training)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], n_experts).float().mean(dim=(0, 1))
    return n_experts * torch.sum(me * ce)
