"""Parametrization-aware initialization.

``init_params(generator, meta, parametrization, sigma)`` materializes the
flat parameter dict from a ParamMeta tree.  The per-tensor std comes from
the abc-rule, so switching parametrization is a single argument.  Metas with
``init="zeros"`` (query weights per App. D.2, norm gains) are zeroed and
those with ``init="ones"`` (the SSD skip gain ``D_skip``) set to one,
regardless of parametrization.

Draws come from one ``torch.Generator`` on the target device, in the
dotted-name order of :func:`flatten_meta`; torch cannot replay JAX's PRNG,
so the port's init is held to the reference by its statistics, not its bits.

``init_candidates`` inits a sweep's N candidates stacked on a leading axis:
candidate i from its own generator (``core.tuning.candidate_generators``,
the counterpart of the reference's per-candidate ``fold_in`` keys) with its
own sigma.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

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
    if meta.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if meta.init != "normal":
        raise ValueError(f"unknown init kind {meta.init!r} for {meta.name}")
    std = meta.rule(parametrization, sigma).init_std
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    # in place: one copy of a large tensor (mixtral's experts are 25.8 GB a
    # 4-layer stack)
    return w.mul_(std).to(dtype)


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


def init_candidates(
    generators: Sequence[torch.Generator],
    meta: Any,
    parametrization: AbcParametrization,
    sigmas: Sequence[float],
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """N candidates' flat params stacked on a leading axis: candidate i is
    ``init_params(generators[i], ..., sigma=sigmas[i])``."""
    if len(generators) != len(sigmas):
        raise ValueError(f"{len(generators)} generators for {len(sigmas)} sigmas")
    per = [init_params(g, meta, parametrization, float(s), dtype)
           for g, s in zip(generators, sigmas)]
    return {name: torch.stack([p[name] for p in per]) for name in per[0]}
