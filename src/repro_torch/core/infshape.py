"""InfShape bookkeeping — per-tensor (dim, base_dim) tracking.

The port's copy of ``repro.core.infshape``: the analogue of ``mup``'s
``p.infshape`` attribute
(Appendix H of the paper).  Every parameter tensor in the framework carries an
:class:`InfShape`: for each of its dimensions we record the *actual* size and
the *base* size (the size at the base model shape where muP coincides with SP,
Eq. (4)).  A dimension is "infinite" if it scales with width — i.e. if its
base size differs from its actual size, or it is explicitly tagged as a width
dimension.  Finite dimensions (vocab, context, kernel size, n_experts, ...)
keep base == dim and ``is_width=False``.

InfShapes are plain frozen dataclasses, so metas holding them hash (the
forward-multiplier cache in models/layers.py keys on them).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class InfDim:
    """One dimension of a parameter tensor.

    dim:      actual size in this model instance.
    base_dim: size at the base model shape (where muP == SP).
    is_width: whether this dimension scales with width ("infinite").
    """

    dim: int
    base_dim: int
    is_width: bool = True

    def __post_init__(self):
        if self.dim <= 0 or self.base_dim <= 0:
            raise ValueError(f"InfDim sizes must be positive, got {self}")

    @property
    def width_mult(self) -> float:
        """n / n0 — the tilde-n of Eq. (4). 1.0 for finite dims."""
        if not self.is_width:
            return 1.0
        return self.dim / self.base_dim

    @staticmethod
    def finite(dim: int) -> "InfDim":
        return InfDim(dim=dim, base_dim=dim, is_width=False)

    @staticmethod
    def inf(dim: int, base_dim: int) -> "InfDim":
        return InfDim(dim=dim, base_dim=base_dim, is_width=True)


@dataclasses.dataclass(frozen=True)
class InfShape:
    """The InfShape of a parameter tensor: a tuple of InfDims plus semantics.

    Fan-in and fan-out axes are explicit (`fan_in_axes`/`fan_out_axes`), so
    einsum-shaped tensors (e.g. attention (d, H, hd)) need no reshapes.
    """

    dims: Tuple[InfDim, ...]
    fan_in_axes: Tuple[int, ...] = (-2,)
    fan_out_axes: Tuple[int, ...] = (-1,)

    def __post_init__(self):
        nd = len(self.dims)
        for ax in tuple(self.fan_in_axes) + tuple(self.fan_out_axes):
            if not (-nd <= ax < nd):
                raise ValueError(
                    f"axis {ax} out of range for {nd}-d InfShape {self.dims}"
                )

    # -- basic accessors ---------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(d.dim for d in self.dims)

    @property
    def base_shape(self) -> Tuple[int, ...]:
        return tuple(d.base_dim for d in self.dims)

    def _agg(self, axes: Sequence[int], attr: str) -> int:
        total = 1
        for ax in axes:
            total *= getattr(self.dims[ax], attr)
        return total

    @property
    def fan_in(self) -> int:
        return self._agg(self.fan_in_axes, "dim")

    @property
    def fan_out(self) -> int:
        return self._agg(self.fan_out_axes, "dim")

    @property
    def base_fan_in(self) -> int:
        return self._agg(self.fan_in_axes, "base_dim")

    @property
    def base_fan_out(self) -> int:
        return self._agg(self.fan_out_axes, "base_dim")

    def fan_in_is_width(self) -> bool:
        return any(self.dims[ax].is_width for ax in self.fan_in_axes)

    def fan_out_is_width(self) -> bool:
        return any(self.dims[ax].is_width for ax in self.fan_out_axes)

    # -- muP quantities ----------------------------------------------------
    @property
    def width_mult(self) -> float:
        """fan_in / base_fan_in when fan_in is a width dim, else 1.

        This is ``p.infshape.width_mult()`` from the mup package: the factor
        by which per-tensor Adam LR of hidden weights is divided (Table 8).
        """
        if self.fan_in_is_width():
            return self.fan_in / self.base_fan_in
        return 1.0

    @property
    def fan_out_mult(self) -> float:
        if self.fan_out_is_width():
            return self.fan_out / self.base_fan_out
        return 1.0

    def n_inf_dims(self) -> int:
        """Number of *distinct* width axes → matrix-like (2), vector-like (1),
        scalar-like (0) classification of Appendix B."""
        n = 0
        seen = set()
        nd = len(self.dims)
        for ax in list(self.fan_in_axes) + list(self.fan_out_axes):
            ax = ax % nd
            if ax in seen:
                continue
            seen.add(ax)
            if self.dims[ax].is_width:
                n += 1
        # count width dims not covered by fan axes too (e.g. stacked-layer dim
        # is finite, so this rarely triggers; defensive)
        for ax, d in enumerate(self.dims):
            if ax not in seen and d.is_width:
                n += 1
        return min(n, 2)


def make_infshape(
    shape: Sequence[int],
    base_shape: Sequence[int],
    width_axes: Sequence[int],
    fan_in_axes: Sequence[int] = (-2,),
    fan_out_axes: Sequence[int] = (-1,),
) -> InfShape:
    """Convenience constructor.

    width_axes: which axes are width ("infinite") dims.
    """
    if len(shape) != len(base_shape):
        raise ValueError(f"shape {shape} vs base_shape {base_shape} rank mismatch")
    nd = len(shape)
    width = {ax % nd for ax in width_axes}
    dims = tuple(
        InfDim(dim=s, base_dim=b, is_width=(i in width))
        for i, (s, b) in enumerate(zip(shape, base_shape))
    )
    return InfShape(dims=dims, fan_in_axes=tuple(fan_in_axes), fan_out_axes=tuple(fan_out_axes))
