"""Gradient utilities: global-norm clipping, bf16 compression with error
feedback, and microbatch gradient accumulation.

The port's copy of ``repro.optim.grad``, over flat dicts of tensors.
Clipping with a width-constant clip value is muP-compatible (App. B.3).
Compression rounds grads to bf16 before they would cross devices and
carries the rounding residual to the next step (error feedback).  Gradients
come from ``torch.autograd.grad`` over leaf copies of the params, so the
params themselves never require grad.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Scale every grad by ``min(1, max_norm / (norm + 1e-12))``; returns the
    scaled grads and the norm (a 0-d tensor: no host sync)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {n: g * scale for n, g in grads.items()}, norm


def compress_bf16(grads: Tensors, residual: Optional[Tensors]) -> Tuple[Tensors, Tensors]:
    """Quantize grads to bf16 with error feedback.

    Returns (quantized as float32, new residual).  Call before the optimizer.
    """
    if residual is not None:
        grads = {n: g + residual[n] for n, g in grads.items()}
    q = {n: g.to(torch.bfloat16).float() for n, g in grads.items()}
    return q, {n: g - q[n] for n, g in grads.items()}


def value_and_grad(loss_fn: Callable, params: Tensors, batch,
                   has_aux: bool = False) -> Tuple[Any, Tensors]:
    """``(loss, {name: dloss/dparam})`` of ``loss_fn(params, batch)``;
    with ``has_aux`` the loss_fn returns ``(loss, aux)`` and the first
    item is ``(loss, aux)``, as ``jax.value_and_grad(has_aux=True)``."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    out = loss_fn(leaves, batch)
    loss = out[0] if has_aux else out
    grads = torch.autograd.grad(loss, list(leaves.values()))
    value = (loss.detach(), out[1]) if has_aux else loss.detach()
    return value, dict(zip(leaves, grads))


def accumulate_gradients(
    loss_fn: Callable,
    params: Tensors,
    batch: Dict[str, torch.Tensor],
    num_microbatches: int,
) -> Tuple[torch.Tensor, Tensors]:
    """Microbatched gradient accumulation: the batch's leading dim is split
    into ``num_microbatches`` equal parts, run one after another (memory of
    one microbatch).  Returns (mean loss, mean grads in float32)."""
    if num_microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} is not divisible into {num_microbatches} "
                         f"microbatches")
    mb = b // num_microbatches
    loss_sum = None
    g_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    for i in range(num_microbatches):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, grads = value_and_grad(loss_fn, params, micro)
        for n, g in grads.items():
            g_sum[n] += g.float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / num_microbatches
    return loss_sum * inv, {n: g * inv for n, g in g_sum.items()}
