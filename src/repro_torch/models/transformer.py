"""Block assembly: pattern-based decoder stacks over stacked layer groups.

A config declares a repeating *group* of blocks (``cfg.pattern``).  The
parameters of each block position in the group are stacked over
``n_groups`` on a leading layer axis, exactly as in the reference, so weights
transfer 1:1 by dotted name; where the reference scans over the stack, the
port runs a Python loop over the layers of every stacked tensor.

The port runs the "attn" block kind (global self-attention + MLP) in two
modes: full sequence ("train" / "prefill"; prefill also emits a cache) and
paged decode (one token per slot through the flash-decode kernel).  Full
sequences go through the flash-attention kernels when ``cfg.amp`` is set
and the positions are 0..S-1, through plain attention otherwise, as in the
reference.  The other kinds arrive with their blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.infshape import InfDim, InfShape
from repro_torch.core.meta import ParamMeta
from repro_torch.core.parametrization import resolve
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    activation,
    apply_w,
    dense_meta,
    gain_meta,
    rmsnorm,
    wmeta,
)
from repro_torch.models.rope import rope_cos_sin, rotate
from repro_torch.quant import policy_of
from repro_torch.serving import kv_cache as paged_kv

BLOCK_KINDS = ("attn",)


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through all blocks."""

    positions: torch.Tensor              # (B, S) token positions
    mode: str = "train"                  # "train" | "prefill" | "decode"
    cache_len: int = 0                   # prefill: emitted KV cache length
    paged: Optional[Any] = None          # serving.kv_cache.PagedState:
                                         # decode reads and writes the paged
                                         # block pool through the page tables
    impl: str = "auto"                   # kernel dispatch (kernels/ops.py)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                                         # (cos, sin) of the positions, shared
                                         # by every layer (models/rope.py)
    writes: Optional[Any] = None         # decode: where each slot's token
                                         # lands in the pools, shared by every
                                         # layer (kv_cache.write_slots)
    aligned_positions: bool = False      # positions are 0..S-1 in every row
                                         # (the flash kernels mask by index)


# ---------------------------------------------------------------------------
# meta construction
# ---------------------------------------------------------------------------

def _attn_meta(cfg, name: str) -> Dict[str, ParamMeta]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bd, bH, bK, bhd = (
        cfg.base_d_model, cfg.base_n_heads, cfg.base_n_kv_heads, cfg.base_d_head
    )
    q_init = "zeros" if (cfg.zero_init_query and cfg.parametrization != "sp") else "normal"
    return {
        "wq": wmeta(
            f"{name}.wq", (d, H, hd), (bd, bH, bhd), width_axes=(0, 1, 2),
            fan_in_axes=(0,), fan_out_axes=(1, 2), init=q_init,
        ),
        "wk": wmeta(
            f"{name}.wk", (d, K, hd), (bd, bK, bhd), width_axes=(0, 1, 2),
            fan_in_axes=(0,), fan_out_axes=(1, 2),
        ),
        "wv": wmeta(
            f"{name}.wv", (d, K, hd), (bd, bK, bhd), width_axes=(0, 1, 2),
            fan_in_axes=(0,), fan_out_axes=(1, 2),
        ),
        "wo": wmeta(
            f"{name}.wo", (H, hd, d), (bH, bhd, bd), width_axes=(0, 1, 2),
            fan_in_axes=(0, 1), fan_out_axes=(2,),
        ),
    }


def _mlp_meta(cfg, name: str) -> Dict[str, ParamMeta]:
    d, f = cfg.d_model, cfg.d_ff
    bd, bf = cfg.base_d_model, cfg.base_d_ff
    glu = cfg.act.endswith("_glu")
    return {
        "wi": wmeta(
            f"{name}.wi", (d, (2 if glu else 1) * f), (bd, (2 if glu else 1) * bf),
            width_axes=(0, 1), fan_in_axes=(0,), fan_out_axes=(1,),
        ),
        "wo": dense_meta(f"{name}.wo", f, d, bf, bd),
    }


def block_meta(cfg, kind: str, name: str) -> Dict[str, Any]:
    if kind not in BLOCK_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ported: {BLOCK_KINDS})"
        )
    d, bd = cfg.d_model, cfg.base_d_model
    return {
        "ln1": gain_meta(f"{name}.ln1", d, bd),
        "attn": _attn_meta(cfg, f"{name}.attn"),
        "ln2": gain_meta(f"{name}.ln2", d, bd),
        "mlp": _mlp_meta(cfg, f"{name}.mlp"),
    }


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_meta(meta: Any, n: int) -> Any:
    """Lift a block meta tree to a stack of n layers (leading finite dim)."""

    def lift(m: ParamMeta) -> ParamMeta:
        ish = m.infshape
        nd = len(ish.dims)
        shift = lambda axes: tuple((a % nd) + 1 for a in axes)
        new_ish = InfShape(
            dims=(InfDim.finite(n),) + ish.dims,
            fan_in_axes=shift(ish.fan_in_axes),
            fan_out_axes=shift(ish.fan_out_axes),
        )
        return dataclasses.replace(m, name=f"stacked.{m.name}", infshape=new_ish)

    return tree_map(lift, meta)


def unstack_meta(m: ParamMeta) -> ParamMeta:
    """Inverse of stack_meta: the meta of one layer of the stack."""
    ish = m.infshape
    nd1 = len(ish.dims)
    unshift = lambda axes: tuple((a % nd1) - 1 for a in axes)
    new_ish = InfShape(
        dims=ish.dims[1:],
        fan_in_axes=unshift(ish.fan_in_axes),
        fan_out_axes=unshift(ish.fan_out_axes),
    )
    return dataclasses.replace(
        m, name=m.name.replace("stacked.", ""), infshape=new_ish
    )


def stack_group_meta(cfg) -> Dict[str, Any]:
    """Meta for the repeated group: {"<i>_<kind>": stacked block meta}."""
    return {
        f"{i}_{kind}": stack_meta(
            block_meta(cfg, kind, f"group.{i}.{kind}"), cfg.n_groups
        )
        for i, kind in enumerate(cfg.pattern)
    }


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _self_attention(cfg, params, meta, x, ctx: Ctx, cache, p13n):
    """Returns (attn_out, new_cache)."""
    S = x.shape[1]
    q = apply_w(x, params["wq"], meta["wq"], p13n, "bsd,dhk->bshk")
    k = apply_w(x, params["wk"], meta["wk"], p13n, "bsd,dkh->bskh")
    v = apply_w(x, params["wv"], meta["wv"], p13n, "bsd,dkh->bskh")
    if cfg.rope_theta > 0:
        q = rotate(q, *ctx.rope)
        k = rotate(k, *ctx.rope)
    scale = resolve(p13n).attention_scale(cfg.d_head, cfg.base_d_head, cfg.alpha_attn)

    new_cache = None
    if ctx.mode in ("train", "prefill"):
        if ctx.mode == "prefill":
            # the full-length, identity-ordered cache the engine pages in;
            # out-of-range positions (prompt padding) are dropped
            new_cache = attn_lib.cache_from_prefill(
                k, v, ctx.positions, ctx.cache_len, dtype=k.dtype
            )
        if cfg.amp and ctx.aligned_positions:
            # flash attention (B5 forward, B6/B7 backward) under the
            # mixed-precision policy; the plain path below masks by the
            # positions themselves, which the kernels' index mask matches
            # only when they are 0..S-1
            out = ops.attention(
                q, k, v, scale=scale, causal=True, softcap=cfg.attn_softcap,
                policy=policy_of(cfg), impl=ctx.impl,
            )
        else:
            mask = attn_lib.make_mask(ctx.positions, ctx.positions)
            out = attn_lib.attend(q, k, v, mask, scale, cfg.attn_softcap)
    elif ctx.mode == "decode":
        paged = ctx.paged
        if paged is None:
            raise NotImplementedError("the port decodes over the paged pool only")
        if S != 1:
            raise NotImplementedError(
                "multi-token paged decode (speculative verify, chunked "
                "prefill) is not ported yet"
            )
        table = paged.global_table
        new_cache = paged_kv.paged_cache_write(
            cache, k, v, ctx.positions, table, paged.active, paged.page_size,
            slots=ctx.writes,
        )
        out = ops.decode_attention(
            q[:, 0], new_cache["k"], new_cache["v"], new_cache["pos"],
            table, ctx.positions[:, 0], scale=scale,
            softcap=cfg.attn_softcap, impl=ctx.impl,
        )[:, None]
    else:
        raise ValueError(f"unknown mode {ctx.mode!r}")
    out = apply_w(out, params["wo"], meta["wo"], p13n, "bshk,hkd->bsd")
    return out, new_cache


def _mlp(cfg, params, meta, h, p13n):
    act = activation(cfg.act.replace("_glu", ""))
    hh = apply_w(h, params["wi"], meta["wi"], p13n, "bsd,df->bsf")
    if cfg.act.endswith("_glu"):
        g, u = torch.chunk(hh, 2, dim=-1)
        hh = act(g) * u
    else:
        hh = act(hh)
    return apply_w(hh, params["wo"], meta["wo"], p13n, "bsf,fd->bsd")


def apply_block(
    cfg, kind: str, params, meta, x, ctx: Ctx, cache=None
) -> Tuple[torch.Tensor, Any]:
    """One residual block.  Returns (x, new_cache)."""
    p13n = resolve(cfg.parametrization)
    eps = cfg.norm_eps
    h = rmsnorm(x, params["ln1"], eps, impl=ctx.impl)
    out, attn_cache = _self_attention(
        cfg, params["attn"], meta["attn"], h, ctx,
        None if cache is None else cache.get("attn"), p13n,
    )
    x = x + out
    h2 = rmsnorm(x, params["ln2"], eps, impl=ctx.impl)
    x = x + _mlp(cfg, params["mlp"], meta["mlp"], h2, p13n)
    return x, (None if attn_cache is None else {"attn": attn_cache})


def run_stack(
    cfg,
    group_params: Dict[str, Any],
    layer_meta: Dict[str, Any],
    x: torch.Tensor,
    ctx: Ctx,
    caches: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Loop over the stacked groups.  ``layer_meta`` holds the unstacked meta
    of each group key.  ``caches`` mirrors the params layout,
    {"groups": {key: stacked cache}}.

    Prefill returns the emitted per-layer caches stacked over the layer
    axis.  Decode writes the paged pools in place — each layer's pool is a
    view into the stacked pool — and returns ``caches`` itself.
    """
    keys = [f"{i}_{kind}" for i, kind in enumerate(cfg.pattern)]
    if cfg.rope_theta > 0:
        ctx.rope = rope_cos_sin(ctx.positions, cfg.d_head, cfg.rope_theta)
    if ctx.mode == "decode" and ctx.paged is not None:
        paged = ctx.paged
        ctx.writes = paged_kv.write_slots(
            ctx.positions, paged.global_table, paged.active, paged.page_size
        )
    emitted = {k: [] for k in keys}
    # each stacked tensor split into its layers once per forward: under
    # autograd one UnbindBackward stacks the layers' gradients, where a
    # ``t[layer]`` per layer would write a stack-sized gradient per layer
    layers = {k: tree_map(lambda t: torch.unbind(t, 0), group_params[k])
              for k in keys}
    for layer in range(cfg.n_groups):
        for i, kind in enumerate(cfg.pattern):
            k = keys[i]
            p = tree_map(lambda ts: ts[layer], layers[k])
            c_in = None
            if caches is not None:
                c_in = tree_map(lambda t: t[layer], caches["groups"][k])
            x, c_out = apply_block(cfg, kind, p, layer_meta[k], x, ctx, c_in)
            if ctx.mode == "prefill":
                emitted[k].append(c_out)
    if ctx.mode == "prefill":
        stacked = {
            k: {"attn": {
                name: torch.stack([c["attn"][name] for c in emitted[k]])
                for name in emitted[k][0]["attn"]
            }}
            for k in keys
        }
        return x, {"groups": stacked}
    return x, caches
