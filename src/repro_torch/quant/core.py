"""Quantize/dequantize primitives and policy-routed matmuls: the port's copy
of ``repro.quant.core``.

  - :func:`quantize_int8` / :func:`dequantize_int8` — symmetric int8 with
    absmax/127 scales along an axis (the int8 KV pools' scales are managed
    in :mod:`repro_torch.quant.kv`).

  - :func:`kernel_dot` — ``a @ b`` with f32 output under the policy, the
    arithmetic each tile matmul of the flash-attention kernels performs.
  - :func:`quant_matmul` — a straight-through ``torch.autograd.Function``
    for plain call sites (the readout logit matmul, the plain attention):
    forward runs the policy's dot, backward runs the same policy on
    ``dX = g·Wᵀ`` and ``dW = Xᵀ·g``.

bf16 mode rounds each operand to bf16 and multiplies the rounded values in
f32: each product of two bf16 values is exact in f32, so this is
``jax.lax.dot(bf16, bf16, preferred_element_type=f32)`` up to summation
order.  A matmul of two bf16 tensors would return bf16 and round the f32
accumulation away; it is never used here.

int8 mode quantizes ``a`` per row and ``b`` per column over the contraction
axis (:func:`quantize_int8`), sums the int8 products exactly and rescales
in f32, ``acc * sa * sb`` in that order.  The sum runs as a float64 matmul
of the int8 values: every partial sum is an integer below 2^53, so any
summation order gives the exact int32 result, on the CPU and on the card,
at any shape (an f32 matmul is exact only while k * 127^2 < 2^24, ~1,040
terms; the readout's dW contracts all B * S rows).  ``acc.float()``
rounds an integer above 2^24 to nearest even, as the reference's
``astype(float32)`` of its int32 does.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
_EPS = 1e-12


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """absmax / 127 by a true division on every device: on the card a tensor
    divided by a Python number is multiplied by its reciprocal, which can be
    an ulp off the reference's quotient and move a byte on a half step."""
    return amax / torch.full_like(amax, INT8_MAX)


def quantize_int8(x: torch.Tensor, axis=-1):
    """Symmetric int8 quantization with absmax/127 scales along ``axis``.

    Returns ``(q, scale)`` with ``q`` int8 and ``scale`` f32 keeping the
    reduced axis as size 1, so ``q * scale`` broadcasts back.  Rounds half
    to even (``torch.round``, as ``jnp.round``)."""
    xf = x.float()
    scale = int8_scale(xf.abs().amax(dim=axis, keepdim=True))
    q = torch.round(xf / scale.clamp(min=_EPS))
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``q * scale`` in f32."""
    return q.float() * scale


def kernel_dot(a: torch.Tensor, b: torch.Tensor, policy=None) -> torch.Tensor:
    """Policy-routed (batched) matmul ``a @ b`` with f32 output.

    ``"none"`` → f32 matmul; ``"bf16"`` → bf16-rounded operands, f32
    products and accumulation; ``"int8"`` → per-row scales of ``a`` (over
    its last axis), per-column scales of ``b`` (over its axis -2), exact
    integer accumulation, f32 rescale.  A batched call is the reference's
    ``vmap`` of its 2-D ``kernel_dot``.
    """
    mode = getattr(policy, "matmul", "none") if policy is not None else "none"
    if mode == "bf16":
        # round to nearest even, then widen: the products are exact in f32
        return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())
    if mode == "int8":
        qa, sa = quantize_int8(a, axis=-1)      # (..., m, k) -> scales (..., m, 1)
        qb, sb = quantize_int8(b, axis=-2)      # (..., k, n) -> scales (..., 1, n)
        acc = torch.matmul(qa.double(), qb.double())
        return acc.float() * sa * sb
    return torch.matmul(a.float(), b.float())


class _QuantMatmul(torch.autograd.Function):
    """Straight-through policy matmul: the rounding counts as identity in
    the backward, whose two matmuls run under the same policy."""

    @staticmethod
    def forward(ctx, x, w, policy):
        ctx.save_for_backward(x, w)
        ctx.policy = policy
        return kernel_dot(x, w, policy)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = kernel_dot(g, w.transpose(-1, -2), ctx.policy)
        dw = kernel_dot(x.transpose(-1, -2), g, ctx.policy)
        return dx.to(x.dtype), dw.to(w.dtype), None


def quant_matmul(x: torch.Tensor, w: torch.Tensor, policy=None) -> torch.Tensor:
    """Policy-routed matmul ``x @ w`` with straight-through gradients.

    A 2-D ``w`` takes an ``x`` with leading batch dims (collapsed to rows,
    as in the reference).  A batched ``w`` takes an ``x`` with the same
    leading dims: one matmul per leading index, which is what the
    reference's ``vmap`` of ``quant_matmul`` computes.  The output is f32.
    """
    if w.ndim == 2:
        lead = x.shape[:-1]
        out = _QuantMatmul.apply(x.reshape(-1, x.shape[-1]), w, policy)
        return out.reshape(*lead, w.shape[-1])
    return _QuantMatmul.apply(x, w, policy)
