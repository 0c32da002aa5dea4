"""Primitive layers: meta constructors + functional apply with muP multipliers.

A layer here is a pair: ``*_meta(...) -> ParamMeta`` (called at build time)
and an apply helper that folds in the abc-rule forward multiplier, resolved
statically from (parametrization, InfShape).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.infshape import make_infshape
from repro_torch.core.meta import ParamMeta
from repro_torch.core.parametrization import AbcParametrization, Role, resolve
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# meta constructors
# ---------------------------------------------------------------------------


def wmeta(
    name: str,
    shape: Sequence[int],
    base_shape: Sequence[int],
    width_axes: Sequence[int],
    fan_in_axes: Sequence[int],
    fan_out_axes: Sequence[int],
    init: str = "normal",
    role: Optional[Role] = None,
    init_scale: float = 1.0,
    owns_scale: bool = True,
    lr_axis: str = "lr",
) -> ParamMeta:
    ish = make_infshape(
        shape, base_shape, width_axes, fan_in_axes=fan_in_axes, fan_out_axes=fan_out_axes
    )
    return ParamMeta(
        name=name,
        infshape=ish,
        role=role,
        init=init,
        init_scale=init_scale,
        owns_scale=owns_scale,
        lr_axis=lr_axis,
    )


def dense_meta(
    name: str, d_in: int, d_out: int, base_in: int, base_out: int
) -> ParamMeta:
    """A (d_in, d_out) hidden (width -> width) kernel."""
    return wmeta(
        name,
        (d_in, d_out),
        (base_in, base_out),
        width_axes=(0, 1),
        fan_in_axes=(0,),
        fan_out_axes=(1,),
    )


def gain_meta(name: str, d: int, base_d: int) -> ParamMeta:
    """Norm gain: vector-like, 'input weight with input 1' (App. B.1).

    Zero-initialized under the gemma-style ``(1 + gain)`` convention.
    """
    return wmeta(
        name,
        (d,),
        (base_d,),
        width_axes=(0,),
        fan_in_axes=(0,),
        fan_out_axes=(0,),
        init="zeros",
        role=Role.INPUT,
        owns_scale=False,   # applied raw by rmsnorm (no multiplier)
    )


# ---------------------------------------------------------------------------
# functional helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mult_cached(parametrization: AbcParametrization, meta: ParamMeta) -> float:
    return meta.rule(parametrization).multiplier


def mult_of(meta: ParamMeta, parametrization) -> float:
    """Static forward multiplier for a tensor (1.0 except output-like in the
    muP Table-8/9 formulations and everything scale-owning under u-µP)."""
    return _mult_cached(resolve(parametrization), meta)


def apply_w(
    x: torch.Tensor,
    w: torch.Tensor,
    meta: ParamMeta,
    parametrization,
    einsum: str,
) -> torch.Tensor:
    m = mult_of(meta, parametrization)
    y = torch.einsum(einsum, x, w.to(x.dtype))
    if m != 1.0:
        # the multiplier in the activation dtype, after the product, as the
        # reference applies it
        y = y * torch.tensor(m, dtype=x.dtype).item()
    return y


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm with the gemma ``(1 + gain)`` convention, f32 accumulation,
    through the kernels.ops dispatcher: the CUDA kernel on the card."""
    return ops.fused_rmsnorm(x, gain, eps=eps, impl=impl)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def activation(name: str):
    return {
        "relu": F.relu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "silu": F.silu,
    }[name]
