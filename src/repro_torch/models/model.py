"""Top-level model: ``build_model(cfg, device)`` -> Model (init / forward /
loss / prefill).

The port's counterpart of ``repro.models.model`` for the dense decoder-only
("lm", all-"attn") architectures.  Params are a flat ``{dotted name:
tensor}`` dict with the reference's names and shapes (see core/meta.py), so
``convert.params_from_numpy`` carries reference weights over 1:1.
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
from repro_torch.quant import policy_of, quant_matmul

ACT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    if cfg.family != "lm" or cfg.tail or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only configs with tied embeddings and "
            f"no tail are ported"
        )
    return {
        "embed": _embed_meta(cfg),
        "groups": tfm.stack_group_meta(cfg),
        "final_norm": gain_meta("final_norm", cfg.d_model, cfg.base_d_model),
    }


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
        self.readout_meta = _readout_view_meta(cfg)

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
    def _embed(self, params, tokens):
        cfg = self.cfg
        dt = self.act_dtype
        x = params["embed"][tokens.long()]
        # the multiplier in the activation dtype, as the reference rounds it
        m = torch.tensor(cfg.alpha_embed * mult_of(self.meta["embed"], self.p13n),
                         dtype=dt).item()
        return x.to(dt) * m

    def _readout(self, params, x):
        cfg = self.cfg
        m = cfg.alpha_output * mult_of(self.readout_meta, self.p13n)
        if cfg.amp:
            # the logit matmul under the mixed-precision policy, straight
            # through; master weights stay f32
            logits = quant_matmul(x.float(), params["embed"].t().float(),
                                  policy_of(cfg))
        else:
            logits = torch.matmul(x, params["embed"].t().to(x.dtype))
        logits = logits.float() * m
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
    ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Logits (B, S, V) f32 and the new cache.

        ``mode="prefill"`` emits a ``cache_len``-long, identity-ordered cache
        for every layer (what the engine pages into a slot).  ``mode="decode"``
        with ``paged`` (a serving.kv_cache.PagedState) writes the new tokens
        into the paged pools ``cache`` in place and attends through the
        flash-decode kernel.
        """
        cfg = self.cfg
        B, S = tokens.shape
        aligned = positions is None   # 0..S-1, made here
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
            positions = positions[None].expand(B, S)
        tree = unflatten(params)
        x = self._embed(tree, tokens)
        ctx = tfm.Ctx(
            positions=positions, mode=mode, cache_len=cache_len,
            paged=paged, impl=self.impl, aligned_positions=aligned,
        )
        x, new_cache = tfm.run_stack(
            cfg, tree["groups"], self.layer_meta, x, ctx, cache,
        )
        x = rmsnorm(x, tree["final_norm"], cfg.norm_eps, impl=self.impl)
        return self._readout(tree, x), new_cache

    def loss_fn(self, params, batch, collect_acts: bool = False):
        """Next-token CE.  batch: tokens (B, S), labels (B, S) (-100 = masked).

        The per-token CE goes through ops.softmax_cross_entropy: the chunked
        CUDA kernels on the card (never a (B, S, V) log-prob tensor or its
        autograd residual), the plain version on the CPU.  Masked rows get
        zero weight here and so a zero cotangent: their dlogits vanish.
        ``collect_acts`` returns ``(loss, {"logits": logits})``.
        """
        logits, _ = self.forward(params, batch["tokens"], mode="train")
        labels = batch["labels"]
        mask = (labels >= 0).float()
        losses = ops.softmax_cross_entropy(logits, labels, impl=self.impl)
        loss = torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if collect_acts:
            return loss, {"logits": logits}
        return loss

    def prefill(self, params, tokens, cache_len: int = 0):
        cache_len = cache_len or tokens.shape[1]
        logits, cache = self.forward(
            params, tokens, mode="prefill", cache_len=cache_len,
        )
        return logits[:, -1], cache


def build_model(cfg, device="cuda", impl: str = "auto") -> Model:
    return Model(cfg, device=device, impl=impl)
