"""Block assembly: pattern-based decoder stacks over stacked layer groups.

A config declares a repeating *group* of blocks (``cfg.pattern``) plus an
optional non-repeating ``cfg.tail``.  The parameters of each block position
in the group are stacked over ``n_groups`` on a leading layer axis, exactly
as in the reference, so weights transfer 1:1 by dotted name; where the
reference scans over the stack, the port runs a Python loop over the
layers of every stacked tensor.  The tail's blocks (``tail.<i>_<kind>``,
not stacked) run unrolled after the groups, as in the reference.

The port runs six block kinds: "attn" (global self-attention + MLP),
"local" (the same over a sliding window of ``cfg.window_size`` positions;
gemma2 alternates the two), "moe" / "local_moe" (the same attention
with the MLP replaced by models/moe.py's top-k expert FFN: mixtral,
llama4-scout), each with gemma2's post-norms when ``cfg.post_attn_norm``
is set, "ssd" (mamba2: one norm and models/ssm.py's SSD mixer, no
MLP) and "recurrent" (recurrentgemma: models/rglru.py's RG-LRU mixer in
place of attention, then the MLP).  Three modes: full sequence ("train" /
"prefill"; prefill also emits a cache), paged decode (one token per slot through the flash-decode
kernel, a chunk of tokens per slot through the multi-query one; windowed
layers read and write a ring of pages through the window table), and
dense decode (the dense-loop driver's: each layer's position-tagged cache,
a ring for windowed layers, written in place and attended in plain
PyTorch, as the reference attends it; an ssd or recurrent layer's state
h and conv inputs carried into the stacked cache).  Full sequences go
through the flash-attention kernels when ``cfg.amp`` is set and the positions are
0..S-1, through plain
attention otherwise (in query chunks of ``cfg.attn_chunk`` past that
length), as in the reference.  The MoE FFN runs on whatever (B, S) block
the mode gives it (a padded prefill buffer, a chunk, one decode token a
slot), which sets its capacity, as in the reference.  The other kinds
("cross", "dec") arrive with their blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.coord_check import _coord_size as coord_size
from repro_torch.core.infshape import InfDim, InfShape
from repro_torch.core.meta import ParamMeta
from repro_torch.core.parametrization import resolve
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
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

BLOCK_KINDS = ("attn", "local", "moe", "local_moe", "ssd", "recurrent")
# kinds whose mixer carries a recurrent state (h, conv inputs), not a KV cache
STATE_KINDS = ("ssd", "recurrent")


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
    writes: Optional[Any] = None         # decode: where each slot's tokens
                                         # land in the global pools, shared
                                         # by every global layer
                                         # (kv_cache.write_slots)
    ring_writes: Optional[Any] = None    # the same for the windowed layers'
                                         # ring pools (the window table)
    full_prefill_cache: bool = False     # prefill emits the full-length
                                         # identity-ordered cache for every
                                         # layer, windowed ones included (the
                                         # engine pages it in, ring applied
                                         # at page granularity)
    aligned_positions: bool = False      # positions are 0..S-1 in every row
                                         # (the flash kernels mask by index)
    hp: Optional[Any] = None             # core.hp.RuntimeHP: per-candidate
                                         # HPs of a sweep (None -> the cfg's
                                         # baked floats)
    stats: Optional[Dict[str, Any]] = None
                                         # µP-health telemetry sink: when a
                                         # dict, run_stack records the
                                         # residual stream's coordinate size
                                         # (mean |x|) after every block, each
                                         # group key's stacked to an
                                         # (n_groups,) tensor, as the
                                         # reference's scan stacks it (None
                                         # under a sweep's vmap)


def _alpha_attn(cfg, ctx: Ctx):
    """alpha_attn as a float or a (per-candidate) tensor: the runtime-HP
    override when a sweep threads one through, else the config's float."""
    return cfg.alpha_attn if ctx.hp is None else ctx.hp.alpha_attn


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
    m = {"ln1": gain_meta(f"{name}.ln1", d, bd)}
    if kind == "ssd":
        m["mixer"] = ssm_lib.ssd_meta(cfg, f"{name}.ssd")
        return m  # mamba blocks: a single norm, no separate MLP
    if kind == "recurrent":
        m["mixer"] = rglru_lib.rglru_meta(cfg, f"{name}.rglru")
    else:
        m["attn"] = _attn_meta(cfg, f"{name}.attn")
    if cfg.post_attn_norm:
        m["ln1_post"] = gain_meta(f"{name}.ln1_post", d, bd)
    m["ln2"] = gain_meta(f"{name}.ln2", d, bd)
    if kind.endswith("moe"):
        m["mlp"] = moe_lib.moe_meta(cfg, f"{name}.moe")
    else:
        m["mlp"] = _mlp_meta(cfg, f"{name}.mlp")
    if cfg.post_attn_norm:
        m["ln2_post"] = gain_meta(f"{name}.ln2_post", d, bd)
    return m


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_trees(trees):
    """Nested dicts of tensors, one per layer -> one nested dict of the
    tensors stacked on a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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


def tail_meta(cfg) -> Dict[str, Any]:
    """Meta for the non-repeating tail: {"<i>_<kind>": block meta}."""
    return {
        f"{i}_{kind}": block_meta(cfg, kind, f"tail.{i}.{kind}")
        for i, kind in enumerate(cfg.tail)
    }


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _self_attention(cfg, params, meta, x, ctx: Ctx, windowed: bool, cache,
                    p13n):
    """Returns (attn_out, new_cache)."""
    S = x.shape[1]
    window = cfg.window_size if windowed else 0
    q = apply_w(x, params["wq"], meta["wq"], p13n, "bsd,dhk->bshk")
    k = apply_w(x, params["wk"], meta["wk"], p13n, "bsd,dkh->bskh")
    v = apply_w(x, params["wv"], meta["wv"], p13n, "bsd,dkh->bskh")
    if cfg.rope_theta > 0:
        q = rotate(q, *ctx.rope)
        k = rotate(k, *ctx.rope)
    scale = resolve(p13n).attention_scale(cfg.d_head, cfg.base_d_head,
                                          _alpha_attn(cfg, ctx))

    new_cache = None
    if ctx.mode in ("train", "prefill"):
        if ctx.mode == "prefill":
            if ctx.full_prefill_cache:
                # the serving admission path: all cache_len entries in
                # identity order, windowed layers too (the engine applies
                # the ring when it pages them in); out-of-range positions
                # (prompt padding) are dropped
                new_cache = attn_lib.cache_from_prefill(
                    k, v, ctx.positions, ctx.cache_len, dtype=k.dtype
                )
            else:
                clen = min(window, ctx.cache_len) if window else ctx.cache_len
                new_cache = attn_lib.cache_from_prefill(
                    k, v, ctx.positions, clen, dtype=k.dtype,
                    windowed=bool(window),
                )
        if cfg.amp and ctx.aligned_positions:
            # flash attention (B5 forward, B6/B7 backward) under the
            # mixed-precision policy; the plain paths below mask by the
            # positions themselves, which the kernels' index mask matches
            # only when they are 0..S-1
            out = ops.attention(
                q, k, v, scale=scale, causal=True, window=window,
                softcap=cfg.attn_softcap, policy=policy_of(cfg), impl=ctx.impl,
            )
        elif S > cfg.attn_chunk:
            # query chunks: bounded memory for long sequences
            out = attn_lib.attend_chunked(
                q, k, v, ctx.positions, ctx.positions, scale, window=window,
                attn_softcap=cfg.attn_softcap, chunk=cfg.attn_chunk,
            )
        else:
            mask = attn_lib.make_mask(ctx.positions, ctx.positions, True, window)
            out = attn_lib.attend(q, k, v, mask, scale, cfg.attn_softcap)
    elif ctx.mode == "decode" and ctx.paged is None:
        # the dense-loop driver: the position-tagged cache (a ring for a
        # windowed layer) written in place, plain attention over it
        new_cache = attn_lib.cache_write(cache, k, v, ctx.positions, bool(window))
        mask = attn_lib.make_mask(ctx.positions, new_cache["pos"], True, window)
        out = attn_lib.attend(q, new_cache["k"], new_cache["v"], mask, scale,
                              cfg.attn_softcap)
    elif ctx.mode == "decode":
        paged = ctx.paged
        table = paged.window_table if windowed else paged.global_table
        new_cache = paged_kv.paged_cache_write(
            cache, k, v, ctx.positions, table, paged.active, paged.page_size,
            slots=ctx.ring_writes if windowed else ctx.writes, ring=windowed,
        )
        # int8 pools carry their per-page-per-head scales (None otherwise)
        kv_scales = dict(k_scale=new_cache.get("k_scale"),
                         v_scale=new_cache.get("v_scale"))
        if S == 1:
            out = ops.decode_attention(
                q[:, 0], new_cache["k"], new_cache["v"], new_cache["pos"],
                table, ctx.positions[:, 0], scale=scale, window=window,
                softcap=cfg.attn_softcap, impl=ctx.impl, **kv_scales,
            )[:, None]
        else:
            # a chunk (chunked prefill, a prefix-cache suffix): written into
            # the pages above, so the per-row position mask gives causality
            # within the chunk too
            out = ops.decode_attention_multi(
                q, new_cache["k"], new_cache["v"], new_cache["pos"],
                table, ctx.positions, scale=scale, window=window,
                softcap=cfg.attn_softcap, impl=ctx.impl, **kv_scales,
            )
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
    if kind == "ssd":
        out, ssd_cache = ssm_lib.ssd_block(cfg, params["mixer"], meta["mixer"], h,
                                           p13n, cache, mode=ctx.mode)
        return x + out, ssd_cache
    if kind == "recurrent":
        out, mixer_cache = rglru_lib.rglru_block(
            cfg, params["mixer"], meta["mixer"], h, p13n,
            None if cache is None else cache.get("mixer"), mode=ctx.mode,
        )
        cache_key = "mixer"
    else:
        out, mixer_cache = _self_attention(
            cfg, params["attn"], meta["attn"], h, ctx, paged_kv.windowed(kind),
            None if cache is None else cache.get("attn"), p13n,
        )
        cache_key = "attn"
    if cfg.post_attn_norm:
        out = rmsnorm(out, params["ln1_post"], eps, impl=ctx.impl)
    x = x + out
    h2 = rmsnorm(x, params["ln2"], eps, impl=ctx.impl)
    if kind.endswith("moe"):
        act = activation(cfg.act.replace("_glu", ""))
        mout = moe_lib.moe_ffn(cfg, params["mlp"], meta["mlp"], h2, p13n, act)
    else:
        mout = _mlp(cfg, params["mlp"], meta["mlp"], h2, p13n)
    if cfg.post_attn_norm:
        mout = rmsnorm(mout, params["ln2_post"], eps, impl=ctx.impl)
    x = x + mout
    return x, (None if mixer_cache is None else {cache_key: mixer_cache})


def _copy_state(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy a recurrent layer's new state (nested dicts of tensors) into its
    slot of the dense cache."""
    for name, t in src.items():
        if isinstance(t, dict):
            _copy_state(dst[name], t)
        else:
            dst[name].copy_(t)


def run_stack(
    cfg,
    group_params: Dict[str, Any],
    layer_meta: Dict[str, Any],
    x: torch.Tensor,
    ctx: Ctx,
    caches: Optional[Dict[str, Any]] = None,
    tail_params: Optional[Dict[str, Any]] = None,
    tmeta: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Loop over the stacked groups, then the unrolled tail.  ``layer_meta``
    holds the unstacked meta of each group key, ``tail_params`` / ``tmeta``
    the tail's params and metas by key.  ``caches`` mirrors the params
    layout, {"groups": {key: stacked cache}, "tail": {key: cache}}.

    Prefill returns the emitted per-layer caches, each group key's stacked
    over the layer axis, the tail's as they are.  Decode writes the paged
    pools in place — each layer's pool, int8 scales included, is a view
    into the stacked pool — and returns ``caches`` itself; so does dense
    decode, where an attention layer's cache is written in place through
    its view and an ssd or recurrent layer's new state is copied into its
    slice of the stack (into the tail's own tensors for a tail layer).
    """
    keys = [f"{i}_{kind}" for i, kind in enumerate(cfg.pattern)]
    tail_keys = [f"{i}_{kind}" for i, kind in enumerate(cfg.tail)]
    if cfg.rope_theta > 0:
        ctx.rope = rope_cos_sin(ctx.positions, cfg.d_head, cfg.rope_theta)
    if ctx.mode == "decode" and ctx.paged is not None:
        if cfg.tail:
            raise NotImplementedError(
                f"{cfg.name}: the paged pools hold no tail; serve it with the "
                f"dense-loop driver")
        # where the tokens land, once a forward for all layers of a kind:
        # global layers through the global table, windowed ones through the
        # ring of the window table
        paged = ctx.paged
        windowed = [paged_kv.windowed(k) for k in cfg.pattern]
        if not all(windowed):
            ctx.writes = paged_kv.write_slots(
                ctx.positions, paged.global_table, paged.active, paged.page_size
            )
        if any(windowed):
            ctx.ring_writes = paged_kv.write_slots(
                ctx.positions, paged.window_table, paged.active,
                paged.page_size, ring=True,
            )
    emitted = {k: [] for k in keys}
    # the statistics read detached activations: no autograd node, the
    # backward unchanged
    stats = {k: [] for k in keys} if ctx.stats is not None else None
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
            elif kind in STATE_KINDS and caches is not None:
                _copy_state(c_in, c_out)
            if stats is not None:
                stats[k].append(coord_size(x.detach()))
    if stats is not None:
        for k in keys:
            ctx.stats[f"block/{k}"] = torch.stack(stats[k])
    new_tail = {}
    for k, kind in zip(tail_keys, cfg.tail):
        c_in = None if caches is None else caches["tail"][k]
        x, c_out = apply_block(cfg, kind, tail_params[k], tmeta[k], x, ctx, c_in)
        if ctx.mode == "prefill":
            new_tail[k] = c_out
        elif kind in STATE_KINDS and caches is not None:
            _copy_state(c_in, c_out)
        if ctx.stats is not None:
            ctx.stats[f"block/tail/{k}"] = coord_size(x.detach())
    if ctx.mode == "prefill":
        return x, {"groups": {k: _stack_trees(emitted[k]) for k in keys},
                   "tail": new_tail}
    return x, caches
