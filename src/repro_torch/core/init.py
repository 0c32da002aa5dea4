"""Parametrization-aware initialization.

``init_params(generator, meta, parametrization, sigma)`` materializes the
flat parameter dict from a ParamMeta tree.  The per-tensor std comes from
the abc-rule, so switching parametrization is a single argument.  Metas with
``init="zeros"`` (query weights per App. D.2, norm gains) are zeroed
regardless of parametrization.

Draws come from one ``torch.Generator`` on the target device, in the
dotted-name order of :func:`flatten_meta`; torch cannot replay JAX's PRNG,
so the port's init is held to the reference by its statistics, not its bits.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.meta import ParamMeta, flatten_meta
from repro_torch.core.parametrization import AbcParametrization


def init_one(
    generator: torch.Generator,
    meta: ParamMeta,
    parametrization: AbcParametrization,
    sigma: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    shape = meta.infshape.shape
    device = generator.device
    if meta.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if meta.init != "normal":
        raise ValueError(f"unknown init kind {meta.init!r} for {meta.name}")
    std = meta.rule(parametrization, sigma).init_std
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * std).to(dtype)


def init_params(
    generator: torch.Generator,
    meta: Any,
    parametrization: AbcParametrization,
    sigma: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Flat {dotted name: tensor} params on ``generator.device``."""
    return {
        name: init_one(generator, m, parametrization, sigma, dtype)
        for name, m in flatten_meta(meta).items()
    }
