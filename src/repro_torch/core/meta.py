"""ParamMeta — static per-tensor metadata, parallel to the params.

The port's copy of ``repro.core.meta``.  Every model builds, alongside its
parameters, a nested dict of :class:`ParamMeta` of identical structure.
Initializers and forward multipliers read the same AbcRule resolved from
(parametrization, InfShape, role).  The port's params are a flat dict keyed
by the dotted names :func:`flatten_meta` gives, so weights move 1:1 between
the reference and the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.infshape import InfShape
from repro_torch.core.parametrization import (
    AbcParametrization,
    AbcRule,
    Role,
    infer_role,
    resolve,
)


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    """Static metadata for one parameter tensor.

    name:       dotted path, for logging / per-layer HP overrides.
    infshape:   width bookkeeping (see core.infshape).
    role:       Appendix-B class; inferred from infshape if None.
    init:       "normal" | "zeros" | "ones"  (zeros for query weights per
                App. D.2 and for norm gains under the (1 + gain)
                convention; ones for the SSD skip gain).
    init_scale: extra per-tensor sigma factor (per-layer HP, Table 2).
    lr_scale:   extra per-tensor LR factor (per-layer HP, Table 2).
    lr_axis:    which LR drives this tensor: "lr" (master) or "lr_embed"
                (the App. D.7 per-layer embedding LR).
    owns_scale: the forward pass honors this tensor's abc multiplier and the
                tensor owns its init scale (see AbcParametrization.rule).
    """

    name: str
    infshape: InfShape
    role: Optional[Role] = None
    init: str = "normal"
    init_scale: float = 1.0
    lr_scale: float = 1.0
    lr_axis: str = "lr"
    owns_scale: bool = True

    def resolved_role(self) -> Role:
        return self.role if self.role is not None else infer_role(self.infshape)

    def rule(self, parametrization: AbcParametrization, sigma: float = 1.0) -> AbcRule:
        return resolve(parametrization).rule(
            self.infshape,
            role=self.resolved_role(),
            sigma=sigma,
            init_scale=self.init_scale,
            owns_scale=self.owns_scale,
        )


def flatten_tree(tree: Any, is_leaf) -> Dict[str, Any]:
    """Nested dicts/lists -> {dotted name: leaf}, in the reference's
    ``flatten_meta`` naming."""
    flat = {}

    def rec(node, prefix):
        if is_leaf(node):
            flat[prefix] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}.{i}" if prefix else str(i))
        else:
            raise TypeError(f"unexpected node {type(node)} at {prefix}")

    rec(tree, "")
    return flat


def flatten_meta(meta: Any) -> Dict[str, ParamMeta]:
    return flatten_tree(meta, lambda x: isinstance(x, ParamMeta))
