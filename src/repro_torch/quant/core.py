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
    ``dX = g·Wᵀ`` and ``dW = Xᵀ·g``; under ``torch.func.vmap`` (a sweep's
    candidates) its vmap rule makes one batched call for all of them.

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
_transforms_active = torch._C._are_functorch_transforms_active   # vmap and kin


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
        _QuantMatmulVmap.setup_context(ctx, (x, w, policy), None)
        return _QuantMatmulVmap.forward(x, w, policy)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = kernel_dot(g, w.transpose(-1, -2), ctx.policy)
        dw = kernel_dot(x.transpose(-1, -2), g, ctx.policy)
        return dx.to(x.dtype), dw.to(w.dtype), None


class _QuantMatmulVmap(_QuantMatmul):
    """:class:`_QuantMatmul` under ``torch.func`` transforms (an HP sweep's
    candidates), in the ``setup_context`` form they need; calls outside a
    transform keep the cheaper ``ctx`` form, as ``kernels/ops.py``'s
    Functions do."""

    @staticmethod
    def forward(x, w, policy):
        return kernel_dot(x, w, policy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, policy = inputs
        ctx.save_for_backward(x, w)
        ctx.policy = policy

    @staticmethod
    def vmap(info, in_dims, x, w, policy):
        """N candidates in one call: both operands take the candidate axis
        first, an unbatched one expanded to N, and the call is the batched
        ``kernel_dot`` (scales per candidate: an int8 group never straddles
        two).  A shared ``w`` is never folded into x's rows: its gradient
        is N per-candidate ``dW = xᵀ·g``, each quantized over its own rows,
        summed by the expand's backward, as ``jax.vmap`` of the reference's
        custom_vjp sums them."""
        n = info.batch_size
        xd, wd = in_dims[:2]
        x = x.movedim(xd, 0) if xd is not None else x.expand(n, *x.shape)
        w = w.movedim(wd, 0) if wd is not None else w.expand(n, *w.shape)
        return _quant_matmul_apply(x, w, policy), 0


def _quant_matmul_apply(x, w, policy):
    cls = _QuantMatmulVmap if _transforms_active() else _QuantMatmul
    return cls.apply(x, w, policy)


def quant_matmul(x: torch.Tensor, w: torch.Tensor, policy=None) -> torch.Tensor:
    """Policy-routed matmul ``x @ w`` with straight-through gradients.

    A 2-D ``w`` takes an ``x`` with leading batch dims (collapsed to rows,
    as in the reference).  A batched ``w`` takes an ``x`` with the same
    leading dims: one matmul per leading index, which is what the
    reference's ``vmap`` of ``quant_matmul`` computes.  The output is f32.
    Under ``torch.func.vmap`` the Function's vmap rule makes one call for
    all candidates.
    """
    if w.ndim == 2:
        lead = x.shape[:-1]
        out = _quant_matmul_apply(x.reshape(-1, x.shape[-1]), w, policy)
        return out.reshape(*lead, w.shape[-1])
    return _quant_matmul_apply(x, w, policy)
