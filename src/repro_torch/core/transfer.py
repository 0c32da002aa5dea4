"""muTransfer (Algorithm 1): tune on a proxy, zero-shot copy to the target.

The port's copy of ``repro.core.transfer``.

    1. Parametrize the target model in muP  -> cfg (base shape = proxy-or-own)
    2. Tune a smaller version               -> make_proxy(cfg, ...)
    3. Copy tuned HPs to the target         -> transfer(hps, target_cfg)

Step 3 is *literally a copy* for the muTransferable set (Table 1/2).  The
copy plan is generated from the target parametrization's HP space
(core/hpspace.py), which also validates the candidate (a ``sigma`` sweep
result cannot land on a u-µP target).  Regularization HPs are refused
loudly (Table 1).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hpspace import HParams, HPSpace, mup_space
from repro_torch.core.parametrization import resolve

# Table 1 taxonomy — generated from the axis registry (single source).
MU_TRANSFERABLE = set(mup_space().transferable_names())
NOT_TRANSFERABLE = set(mup_space().not_transferable_names())

__all__ = ["HParams", "MU_TRANSFERABLE", "NOT_TRANSFERABLE", "make_proxy",
           "reverse_transfer", "transfer"]


def make_proxy(
    target: ModelConfig, width_factor: float = 0.25, depth: Optional[int] = None,
    min_d_head: int = 32,
) -> ModelConfig:
    """Algorithm 1 step 2's model: shrink width (and optionally depth) while
    keeping the muP base shape, so HPs found on it are the target's HPs.

    Keeps d_head >= min_d_head (App. D.4: small d_k makes the proxy's HP
    landscape noisy) via ModelConfig.scaled.
    """
    proxy = target.scaled(width_factor, min_d_head=min_d_head)
    if depth is not None:
        # depth transfer (Sec. 6.1): reduce n_groups, keep the pattern
        per = len(target.pattern)
        n_groups = max(depth // per, 1)
        proxy = proxy.replace(
            n_layers=n_groups * per + len(target.tail),
            name=f"{proxy.name}@L{depth}",
        )
    return proxy


def transfer(
    hps: HParams, target: ModelConfig, space: Optional[HPSpace] = None
) -> Dict[str, Any]:
    """Zero-shot transfer: ``{"model": config overrides, "optim": optimizer
    kwargs, "schedule": schedule kwargs}`` to run the *target* with the
    proxy-tuned HPs.  Regularization HPs are not copied (Table 1)."""
    space = space or resolve(target.parametrization).hp_space()
    space.validate([hps], context="transfer")
    bad_reg = [
        n for n in space.not_transferable_names()
        if getattr(hps, n) != space.axis(n).default
    ]
    if bad_reg:
        warnings.warn(
            f"{'/'.join(bad_reg)} are regularization HPs and are NOT "
            "muTransferable (Table 1); they will not be copied — retune "
            "them at target scale.",
            stacklevel=2,
        )
    return space.transfer_plan(hps)


def reverse_transfer(hps: HParams, wide_cfg: ModelConfig, narrow_width: int):
    """Reverse-muTransfer (App. I): replicate a large model's (in)stability
    on a small model by simulating the wide width via the base shape.

    Returns a narrow config whose *base* shape is the wide model — training
    it reproduces the wide model's effective HPs ("simulated width")."""
    factor = narrow_width / wide_cfg.d_model
    narrow = wide_cfg.scaled(factor)
    # keep base anchored at the wide model => same effective parametrization
    return narrow.replace(name=f"{wide_cfg.name}@simwidth{wide_cfg.d_model}")
