"""Mixed-precision policy: which dtype the hot matmuls run in.

The port's copy of ``repro.quant.policy``.  ``QuantPolicy`` is a frozen,
hashable dataclass; the reference also registers it as a leafless pytree,
which is JAX plumbing the port does not need.
"""
from __future__ import annotations

import dataclasses

_AMP_MODES = ("none", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What precision the hot matmuls run in.

    ``matmul``: ``"none"`` (full f32, the default), ``"bf16"`` (operands
    rounded to bf16, f32 accumulation), or ``"int8"`` (scaled int8, not
    ported yet).  Applies to the flash-attention tile matmuls (q·kᵀ, p·v and
    their dq/dk/dv recompute counterparts) and the readout logit matmul.
    Master weights and optimizer state are always f32.
    """

    matmul: str = "none"

    def __post_init__(self) -> None:
        if self.matmul not in _AMP_MODES:
            raise ValueError(
                f"QuantPolicy.matmul must be one of {_AMP_MODES}, got {self.matmul!r}"
            )

    @property
    def active(self) -> bool:
        return self.matmul != "none"


def policy_of(cfg) -> QuantPolicy:
    """Resolve a model config's ``amp`` knob into a :class:`QuantPolicy`."""
    amp = getattr(cfg, "amp", "") or "none"
    return QuantPolicy(matmul=amp)
