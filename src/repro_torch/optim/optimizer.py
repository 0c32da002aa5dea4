"""muP-aware optimizers: SGD(+momentum), Adam, AdamW, Adagrad.

The port's copy of ``repro.optim.optimizer``, over flat ``{dotted name:
tensor}`` dicts.  The optimizer receives the model's meta and resolves, per
tensor,

    effective_lr = master_lr * schedule(t) * rule.lr_mult(adam_like) * meta.lr_scale

with the master LR replaced by ``lr_embed`` for tensors whose
``meta.lr_axis == "lr_embed"`` (App. D.7).  Weight decay is decoupled and
applied with the *master* LR so it stays width-independent (App. B.3); plain
Adam with L2 is refused.  ``mup_scale_eps`` scales eps like 1/fan_in for
µP-class rules.

``update`` returns *deltas* to add to the params.  Unlike the reference's
pure function it updates the moment tensors of ``state`` in place (one f32
copy of the params each, instead of two); the caller passes the state it
got back and must not reuse the old one.

A batched HP sweep (core/tuning.py) stacks N candidates on a leading axis
of every tensor and passes ``lr`` (and ``lr_embed``) as (N,) tensors, each
candidate's own, broadcast over the rest of its tensors; ``active`` then
freezes the moments of the candidates it marks False, bit for bit (the
reference's ``jnp.where(ok, new, old)`` over the state).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.meta import ParamMeta, flatten_meta
from repro_torch.core.parametrization import AbcParametrization, resolve

Schedule = Callable[[int], float]   # step -> multiplicative factor (float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A functional optimizer over flat param dicts; see the module note."""

    kind: str
    lr: float
    lr_mults: Dict[str, float]          # static per tensor
    eps_mults: Dict[str, float]
    lr_embed: Optional[float] = None    # per-layer embedding LR (None: = lr)
    embed_lr_mask: Dict[str, float] = dataclasses.field(default_factory=dict)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.0
    weight_decay: float = 0.0
    schedule: Optional[Schedule] = None

    # ------------------------------------------------------------------
    @staticmethod
    def create(
        kind: str,
        lr: float,
        parametrization: AbcParametrization,
        meta: Any,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        momentum: float = 0.0,
        weight_decay: float = 0.0,
        schedule: Optional[Schedule] = None,
        mup_scale_eps: bool = False,
        lr_embed: Optional[float] = None,
    ) -> "Optimizer":
        """``meta``: the model's meta (nested or flat), whose dotted names
        are the param dict's keys."""
        kind = kind.lower()
        if kind not in ("sgd", "adam", "adamw", "adagrad"):
            raise ValueError(f"unknown optimizer {kind!r}")
        p13n = resolve(parametrization)
        adam_like = kind in ("adam", "adamw", "adagrad")
        if kind == "adam" and weight_decay:
            raise ValueError(
                "L2 weight decay under plain Adam is not muP-compatible "
                "(App. B.3); use adamw."
            )
        flat: Dict[str, ParamMeta] = flatten_meta(meta)
        scale_eps = mup_scale_eps and p13n.is_mup
        return Optimizer(
            kind=kind,
            lr=lr,
            lr_mults={n: m.rule(p13n).lr_mult(adam_like) * m.lr_scale
                      for n, m in flat.items()},
            # eps added after the sqrt scales like 1/width_mult (App. B.3)
            eps_mults={n: 1.0 / m.infshape.width_mult if scale_eps else 1.0
                       for n, m in flat.items()},
            lr_embed=lr_embed,
            embed_lr_mask={n: 1.0 if m.lr_axis == "lr_embed" else 0.0
                           for n, m in flat.items()},
            b1=b1,
            b2=b2,
            eps=eps,
            momentum=momentum,
            weight_decay=weight_decay,
            schedule=schedule,
        )

    # ------------------------------------------------------------------
    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}

        state: Dict[str, Any] = {"count": 0}
        if self.kind == "sgd":
            if self.momentum:
                state["mu"] = zeros()
        elif self.kind == "adagrad":
            state["nu"] = zeros()
        else:
            state["mu"] = zeros()
            state["nu"] = zeros()
        return state

    def update(
        self,
        grads: Dict[str, torch.Tensor],
        state: Dict[str, Any],
        params: Dict[str, torch.Tensor],
        lr: Optional[Any] = None,
        lr_embed: Optional[Any] = None,
        active: Optional[torch.Tensor] = None,
    ):
        """Returns ``(updates, new_state)``; apply with params + updates.

        The moments in ``state`` are updated in place (see the module note).
        ``lr`` overrides the master LR for this call: a float, or an (N,)
        float32 tensor over a leading candidate axis of every tensor (a
        batched sweep: each candidate its own LR).  ``lr_embed`` likewise
        overrides the per-layer embedding LR (the ``lr_axis == "lr_embed"``
        tensors, App. D.7); None falls back to ``self.lr_embed``, then to
        ``lr``.  ``active`` ((N,) bool, with a candidate axis): the moments
        of the candidates marked False keep their bits; their updates are
        still returned, for the caller to drop.
        """
        lr = self.lr if lr is None else lr
        lr_embed = self.lr_embed if lr_embed is None else lr_embed
        per_candidate = isinstance(lr, torch.Tensor) and lr.ndim == 1

        def lr_of(name):
            if lr_embed is None:
                out = lr
            else:
                out = lr + (lr_embed - lr) * self.embed_lr_mask.get(name, 0.0)
            if per_candidate:
                # (N,) -> (N, 1, ...) against the candidate-stacked tensor
                return out.view(-1, *(1,) * (grads[name].ndim - 1))
            return out

        def ema(buf, new):
            """buf <- new(buf), in place; only the active candidates' rows
            when ``active`` is given."""
            if active is None:
                new(buf)
            else:
                ok = active.view(-1, *(1,) * (buf.ndim - 1))
                torch.where(ok, new(buf.clone()), buf, out=buf)

        t = state["count"]
        sched = float(self.schedule(t)) if self.schedule is not None else 1.0
        new_state: Dict[str, Any] = {"count": t + 1}
        updates = {}

        if self.kind == "sgd":
            if self.momentum:
                mu = state["mu"]
                for n, g in grads.items():
                    ema(mu[n], lambda b: b.mul_(self.momentum).add_(g.float()))
                new_state["mu"] = mu
                eff = mu
            else:
                eff = {n: g.float() for n, g in grads.items()}
            for n, g in eff.items():
                lr_t = lr_of(n)
                step = g * (-lr_t * sched * self.lr_mults[n])
                if self.weight_decay:
                    step = step - (lr_t * sched * self.weight_decay) * params[n]
                updates[n] = step.to(params[n].dtype)
            return updates, new_state

        if self.kind == "adagrad":
            nu = state["nu"]
            for n, g in grads.items():
                g = g.float()
                ema(nu[n], lambda b: b.addcmul_(g, g))
                lr_t = lr_of(n)
                step = g * (-lr_t * sched * self.lr_mults[n]) / (
                    torch.sqrt(nu[n]) + self.eps * self.eps_mults[n])
                if self.weight_decay:
                    step = step - (lr_t * sched * self.weight_decay) * params[n]
                updates[n] = step.to(params[n].dtype)
            new_state["nu"] = nu
            return updates, new_state

        # adam / adamw; bias corrections in float32, as the reference's
        # count.astype(f32)
        mu, nu = state["mu"], state["nu"]
        c = np.float32(t + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c)
        for n, g in grads.items():
            g = g.float()
            ema(mu[n], lambda b: b.mul_(self.b1).add_(g, alpha=1 - self.b1))
            ema(nu[n], lambda b: b.mul_(self.b2).addcmul_(g, g, value=1 - self.b2))
            lr_t = lr_of(n)
            step = (mu[n] / bc1) * (-lr_t * sched * self.lr_mults[n]) / (
                torch.sqrt(nu[n] / bc2) + self.eps * self.eps_mults[n])
            if self.kind == "adamw" and self.weight_decay:
                # decoupled, master-LR-scaled: width-independent
                step = step - (lr_t * sched * self.weight_decay) * params[n]
            updates[n] = step.to(params[n].dtype)
        new_state["mu"] = mu
        new_state["nu"] = nu
        return updates, new_state


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: p + updates[n] for n, p in params.items()}
