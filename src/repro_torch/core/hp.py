"""Runtime hyperparameters: the per-candidate HP bundle of a batched sweep.

The port's counterpart of ``repro.core.hp``.  Every µTransferable HP that a
sweep varies per candidate (lr, sigma, alpha_output, alpha_attn,
alpha_embed, lr_embed) travels as :class:`RuntimeHP`: a frozen dataclass
whose leaves are float32 tensors, 0-d for one candidate or ``(N,)`` for a
stacked batch.  It is threaded through

  - ``core.init.init_candidates``        (sigma -> init std),
  - ``models.model.Model.forward``       (alpha_embed / alpha_attn /
                                          alpha_output forward multipliers),
  - ``optim.optimizer.Optimizer.update`` (lr / lr_embed overrides),

so one ``torch.func.vmap`` over a stacked :class:`RuntimeHP` runs all N
candidates' forwards at once (``core.tuning.batched_train``).  The class is
registered as a ``torch.utils._pytree`` node, which is how ``vmap`` maps its
leaves.

The class is **generated** from the HP axis universe
(``repro_torch.core.hpspace.HP_AXES``): every axis with
``engine == "runtime"`` becomes one leaf, in the same order as the
reference's, so the bundle cannot drift from the declared HP space.
Structural HPs (optimizer kind, schedule, b1/b2, width) stay in the config
and the Optimizer, shared by every candidate of a batch.

``lr_embed`` (App. D.7, the per-layer embedding LR) is a real leaf: ``None``
means "follow lr", and stacking substitutes the candidate's own ``lr``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.utils._pytree as pytree

from repro_torch.core.hpspace import HP_AXES

RUNTIME_AXES = tuple(a for a in HP_AXES if a.engine == "runtime")
RUNTIME_NAMES = tuple(a.name for a in RUNTIME_AXES)


def runtime_config_axes(cfg) -> tuple:
    """Names of runtime axes that are also config fields (sigma, alpha_*) —
    the single place the 'baked into the config' intersection is defined."""
    return tuple(
        a.name for a in RUNTIME_AXES
        if a.name != "lr" and hasattr(cfg, a.name)
    )


def _make_runtime_cls():
    cls = dataclasses.make_dataclass(
        "RuntimeHP",
        [
            (a.name, Any, dataclasses.field(default=a.default))
            for a in RUNTIME_AXES
        ],
        frozen=True,
        namespace={
            "__doc__": (
                "Per-candidate HP scalars (generated from hpspace.HP_AXES "
                "runtime axes: " + ", ".join(RUNTIME_NAMES) + ").  Leaves "
                "may be Python floats, 0-d float32 tensors (one candidate) "
                "or (N,) float32 tensors (a stacked candidate batch); None "
                "leaves (lr_embed) mean 'follow lr'."
            ),
            "replace": lambda self, **kw: dataclasses.replace(self, **kw),
        },
    )
    cls.__module__ = __name__
    # a pytree node whose children are its non-None leaves (the names kept
    # as the context), so torch.func.vmap maps the tensors along in_dims
    def flatten(h):
        names = tuple(n for n in RUNTIME_NAMES if getattr(h, n) is not None)
        return [getattr(h, n) for n in names], names

    def unflatten(leaves, names):
        vals = dict.fromkeys(RUNTIME_NAMES)
        vals.update(zip(names, leaves))
        return cls(**vals)

    pytree.register_pytree_node(
        cls, flatten, unflatten, serialized_type_name=f"{__name__}.RuntimeHP",
    )
    return cls


RuntimeHP = _make_runtime_cls()


def stack_hparams(candidates: Sequence[Any], device="cuda") -> "RuntimeHP":
    """Stack N candidates into a RuntimeHP of ``(N,)`` float32 tensors on
    ``device`` — the batch axis that ``torch.func.vmap`` and the optimizer
    map over.

    ``lr_embed=None`` entries fall back to that candidate's ``lr`` (the
    "follow lr" semantics); if *every* candidate leaves it None the leaf
    stays None and the optimizer skips the per-tensor blend entirely.
    """
    if not candidates:
        raise ValueError("stack_hparams: empty candidate list")

    def col(field: str):
        vals = [getattr(h, field) for h in candidates]
        if all(v is None for v in vals):
            return None
        vals = [h.lr if v is None else v for v, h in zip(vals, candidates)]
        return torch.tensor(vals, dtype=torch.float32, device=device)

    return RuntimeHP(**{n: col(n) for n in RUNTIME_NAMES})


def hp_at(stack: "RuntimeHP", i: int) -> "RuntimeHP":
    """Candidate ``i`` of a stacked RuntimeHP (for serial reference runs)."""
    return pytree.tree_map(lambda x: x[i], stack)


def n_candidates(stack: "RuntimeHP") -> int:
    return int(stack.lr.shape[0])
