"""Top-level model: ``build_model(cfg, device)`` -> Model (init / forward /
loss / prefill / decode_step / init_cache).

The port's counterpart of ``repro.models.model`` for the decoder-only ("lm")
architectures: all-"attn" stacks, gemma2's "local"/"attn" alternation with
post-norms and a final softcap, the MoE stacks ("moe", "local_moe")
with an untied readout (``unembed``, zero-init under µP per App. D.2 when
``cfg.zero_init_readout``), mamba2's "ssd" stack, and recurrentgemma's
"recurrent"/"local" groups with their non-repeating tail (``tail.*``).
Params are a flat ``{dotted name: tensor}`` dict with the reference's
names and shapes (see core/meta.py), so ``convert.params_from_numpy``
carries reference weights over 1:1.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.init import init_params
from repro_torch.core.meta import ParamMeta, flatten_meta
from repro_torch.core.parametrization import AbcParametrization, Role, resolve
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import gain_meta, mult_of, rmsnorm, softcap, wmeta
from repro_torch.models.rglru import lru_width
from repro_torch.models.ssm import ssd_heads
from repro_torch.quant import policy_of, quant_matmul

# float64 runs the plain versions only: the reference that a float32
# forward's rounding is measured against
ACT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "float64": torch.float64}


def _embed_meta(cfg) -> ParamMeta:
    V, D, bD = cfg.vocab_size, cfg.d_model, cfg.base_d_model
    # word embedding: input weight with conceptual fan_in 1 (one-hot input);
    # init var sigma^2 independent of both width and vocab (App. B.1).
    # lr_axis="lr_embed": its LR follows the App. D.7 per-layer embedding LR
    # instead of the master lr.
    return wmeta(
        "embed", (V, D), (V, bD), width_axes=(1,),
        fan_in_axes=(0,), fan_out_axes=(1,), role=Role.INPUT,
        init_scale=math.sqrt(V), lr_axis="lr_embed",
    )


def _readout_view_meta(cfg) -> ParamMeta:
    V, D, bD = cfg.vocab_size, cfg.d_model, cfg.base_d_model
    # a *view* of the tied embedding: the underlying tensor owns the init
    # scale, so unit-scaling rules must not shift this multiplier again
    return wmeta(
        "readout_view", (D, V), (bD, V), width_axes=(0,),
        fan_in_axes=(0,), fan_out_axes=(1,), owns_scale=False,
    )


def build_meta(cfg) -> Dict[str, Any]:
    if cfg.family != "lm":
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only configs are ported"
        )
    D, bD = cfg.d_model, cfg.base_d_model
    meta = {
        "embed": _embed_meta(cfg),
        "groups": tfm.stack_group_meta(cfg),
        "tail": tfm.tail_meta(cfg),
        "final_norm": gain_meta("final_norm", D, bD),
    }
    if not cfg.tie_embeddings:
        meta["unembed"] = wmeta(
            "unembed", (D, cfg.vocab_size), (bD, cfg.vocab_size), width_axes=(0,),
            fan_in_axes=(0,), fan_out_axes=(1,),
            init=("zeros" if cfg.zero_init_readout and cfg.parametrization != "sp"
                  else "normal"),
        )
    return meta


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{dotted name: tensor} -> nested dicts."""
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


class Model:
    """The µP decoder on one device.  ``device`` defaults to the card; the
    CPU runs only when asked for (``device="cpu"``).  ``impl`` selects the
    kernel dispatch of every norm, the loss and attention (kernels/ops.py)."""

    def __init__(self, cfg, device="cuda", impl: str = "auto"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = impl
        self.meta = build_meta(cfg)
        self.flat_meta = flatten_meta(self.meta)
        self.layer_meta = {
            k: tfm.tree_map(tfm.unstack_meta, m)
            for k, m in self.meta["groups"].items()
        }
        # the tail's blocks are not stacked: their metas as they are
        self.tail_meta = self.meta["tail"]
        # the readout's own meta (untied) or the tied embedding's view
        self.readout_meta = (_readout_view_meta(cfg) if cfg.tie_embeddings
                             else self.meta["unembed"])

    @property
    def p13n(self) -> AbcParametrization:
        return resolve(self.cfg.parametrization)

    @property
    def act_dtype(self) -> torch.dtype:
        return ACT_DTYPES[self.cfg.dtype]

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Flat params drawn from a ``torch.Generator`` seeded with ``seed``
        on the model's device."""
        # registry hook: each rule vetoes configs it cannot parametrize
        self.p13n.validate_config(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(gen, self.meta, self.p13n, self.cfg.sigma, dtype)

    # ------------------------------------------------------------------
    def _embed(self, params, tokens, hp=None):
        cfg = self.cfg
        dt = self.act_dtype
        x = params["embed"][tokens.long()]
        mult = mult_of(self.meta["embed"], self.p13n)
        # the multiplier in the activation dtype, as the reference rounds it:
        # a Python float from the config, a tensor op from a sweep's RuntimeHP
        # (a per-candidate tensor under vmap)
        if hp is None:
            m = torch.tensor(cfg.alpha_embed * mult, dtype=dt).item()
        else:
            m = torch.as_tensor(hp.alpha_embed * mult, dtype=torch.float32).to(dt)
        return x.to(dt) * m

    def _readout(self, params, x, hp=None):
        cfg = self.cfg
        alpha = cfg.alpha_output if hp is None else hp.alpha_output
        m = alpha * mult_of(self.readout_meta, self.p13n)
        w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
        if cfg.amp:
            # the logit matmul under the mixed-precision policy, straight
            # through; master weights stay f32
            logits = quant_matmul(x.float(), w.float(), policy_of(cfg))
        else:
            logits = torch.matmul(x, w.to(x.dtype))
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32)) * m
        return softcap(logits, cfg.final_softcap)

    # ------------------------------------------------------------------
    def forward(
        self,
        params: Dict[str, torch.Tensor],
        tokens: torch.Tensor,                     # (B, S)
        positions: Optional[torch.Tensor] = None,
        mode: str = "train",
        cache: Optional[Dict] = None,
        cache_len: int = 0,
        paged=None,
        hp=None,
        full_cache: bool = False,
        readout: Optional[torch.Tensor] = None,
        collect_stats: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Logits (B, S, V) f32 (f64 in a float64 forward) and the new cache.

        ``hp`` (a core.hp.RuntimeHP or None) supplies per-call forward
        multipliers (alpha_embed / alpha_attn / alpha_output) in place of
        the config's floats: under ``torch.func.vmap`` over a stacked one,
        each candidate's own (core/tuning.py).

        ``mode="prefill"`` emits a cache per layer: ``cache_len`` entries
        indexed by position, and for a windowed layer a ring of
        ``min(window, cache_len)``; with ``full_cache`` every layer's is the
        ``cache_len``-long, identity-ordered one (what the engine pages into
        a slot, the ring applied there).  ``mode="decode"``
        with ``paged`` (a serving.kv_cache.PagedState) writes the new tokens
        into the paged pools ``cache`` in place and attends through the
        flash-decode kernel (one token per slot) or the multi-query one (a
        chunk per slot; positions -1 mark rows that neither write nor see).
        Without ``paged`` it decodes over a dense cache (prefill's, or
        :meth:`init_cache`'s), which it updates in place.

        ``readout`` (an index along S: an int tensor (n,)) reads out only
        those rows: logits (B, n, V).  The final norm and the logit matmul
        act row by row, so the rows are the full readout's up to the
        matmul's order of summation; an engine that samples from one row of
        a long prefill or chunk saves the (S, vocab) logits (6.6 GB for
        gemma2-2b's 6,400 tokens).

        ``collect_stats`` switches the return to ``(logits, new_cache,
        stats)``: ``stats`` holds the coordinate sizes (mean |x|, 0-d
        tensors on the device) of the embedding (``embed``), the residual
        stream after every block (``block/<i>_<kind>``, (n_groups,); a tail
        block's ``block/tail/<i>_<kind>``, 0-d), the final norm's output
        (``final_norm``) and the logits (``logits``), the reference's µP-health telemetry (obs/telemetry.py).  They are
        read from detached tensors, so the backward is unchanged.
        """
        cfg = self.cfg
        B, S = tokens.shape
        aligned = positions is None   # 0..S-1, made here
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
            positions = positions[None].expand(B, S)
        tree = unflatten(params)
        x = self._embed(tree, tokens, hp=hp)
        stats = {"embed": tfm.coord_size(x.detach())} if collect_stats else None
        ctx = tfm.Ctx(
            positions=positions, mode=mode, cache_len=cache_len,
            paged=paged, impl=self.impl, aligned_positions=aligned, hp=hp,
            full_prefill_cache=full_cache, stats=stats,
        )
        x, new_cache = tfm.run_stack(
            cfg, tree["groups"], self.layer_meta, x, ctx, cache,
            tail_params=tree.get("tail", {}), tmeta=self.tail_meta,
        )
        if readout is not None:
            x = x[:, readout]
        x = rmsnorm(x, tree["final_norm"], cfg.norm_eps, impl=self.impl)
        logits = self._readout(tree, x, hp=hp)
        if collect_stats:
            stats["final_norm"] = tfm.coord_size(x.detach())
            stats["logits"] = tfm.coord_size(logits.detach())
            return logits, new_cache, stats
        return logits, new_cache

    def loss_fn(self, params, batch, collect_acts: bool = False, hp=None,
                collect_stats: bool = False):
        """Next-token CE.  batch: tokens (B, S), labels (B, S) (-100 = masked).

        The per-token CE goes through ops.softmax_cross_entropy: the chunked
        CUDA kernels on the card (never a (B, S, V) log-prob tensor or its
        autograd residual), the plain version on the CPU.  Masked rows get
        zero weight here and so a zero cotangent: their dlogits vanish.
        ``collect_acts`` returns ``(loss, {"logits": logits})``;
        ``collect_stats`` returns ``(loss, stats)`` with :meth:`forward`'s
        µP-health statistics (the two are exclusive, as in the reference);
        ``hp`` is :meth:`forward`'s.
        """
        if collect_acts and collect_stats:
            raise ValueError("collect_acts and collect_stats are exclusive")
        stats = None
        if collect_stats:
            logits, _, stats = self.forward(params, batch["tokens"], mode="train",
                                            hp=hp, collect_stats=True)
        else:
            logits, _ = self.forward(params, batch["tokens"], mode="train", hp=hp)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        losses = ops.softmax_cross_entropy(logits, labels, impl=self.impl)
        loss = torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if collect_acts:
            return loss, {"logits": logits}
        if collect_stats:
            return loss, stats
        return loss

    def prefill(self, params, tokens, cache_len: int = 0):
        cache_len = cache_len or tokens.shape[1]
        logits, cache = self.forward(
            params, tokens, mode="prefill", cache_len=cache_len,
        )
        return logits[:, -1], cache

    def decode_step(self, params, tokens, positions, cache):
        """tokens (B, 1), positions (B, 1) -> (logits (B, 1, V), cache): one
        step of the dense-loop driver over the dense ``cache`` (prefill's or
        init_cache's), which is updated in place and returned."""
        return self.forward(params, tokens, positions=positions, mode="decode",
                            cache=cache)

    # ------------------------------------------------------------------
    def _block_cache_spec(self, kind, batch: int, cache_len: int):
        """{leaf: (shape, dtype)} of one layer's dense decode cache."""
        cfg = self.cfg
        act = self.act_dtype
        if kind == "ssd":
            nh, hd = ssd_heads(cfg)
            return {"h": ((batch, nh, hd, cfg.ssm_state), torch.float32),
                    "conv": ((batch, cfg.conv_width - 1,
                              cfg.d_inner + 2 * cfg.ssm_state), act)}
        if kind == "recurrent":
            # h f32 as in the reference (float64 in a float64 model)
            w = lru_width(cfg)
            return {"mixer": {
                "h": ((batch, w), torch.promote_types(act, torch.float32)),
                "conv": ((batch, cfg.conv_width - 1, w), act)}}
        length = (min(cfg.window_size, cache_len) if kind.startswith("local")
                  else cache_len)
        kv = (batch, length, cfg.n_kv_heads, cfg.d_head)
        return {"attn": {"k": (kv, act), "v": (kv, act),
                         "pos": ((batch, length), torch.int32)}}

    def cache_shapes(self, batch: int, cache_len: int) -> Dict[str, Any]:
        """{"groups": {key: {leaf: (shape, dtype)}}, "tail": {key: ...}} of
        the dense decode cache, the reference's layout: each group leaf
        stacked over the layers, the tail's not ({} with no tail); see
        init_cache."""
        cfg = self.cfg
        return {"groups": {
            f"{i}_{kind}": tfm.tree_map(
                lambda sd: ((cfg.n_groups,) + sd[0], sd[1]),
                self._block_cache_spec(kind, batch, cache_len))
            for i, kind in enumerate(cfg.pattern)},
            "tail": {f"{i}_{kind}": self._block_cache_spec(kind, batch, cache_len)
                     for i, kind in enumerate(cfg.tail)}}

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, Any]:
        """An empty dense decode cache: positions -1 (empty), the rest 0."""
        def make(sd):
            shape, dtype = sd
            if dtype == torch.int32:
                return torch.full(shape, -1, dtype=dtype, device=self.device)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return tfm.tree_map(make, self.cache_shapes(batch, cache_len))


def build_model(cfg, device="cuda", impl: str = "auto") -> Model:
    return Model(cfg, device=device, impl=impl)
