"""Kernel dispatch: the model code calls these, never a kernel directly.

Dispatch contract (shared by every op here):

  impl="auto"    the hand-written CUDA kernel for a CUDA tensor, the plain
                 PyTorch version (kernels/ref.py) for a CPU tensor.
  impl="kernel"  the CUDA kernel; raises for a CPU tensor.
  impl="ref"     the plain PyTorch version, on any device — an explicit
                 caller choice (chip_smoke.py holds each kernel against it on
                 the card).

A CUDA tensor either launches its kernel or raises: there is no fallback on
error, by environment or by shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn

IMPLS = ("auto", "kernel", "ref")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """auto -> "kernel" on the card, "ref" on the CPU."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "ref"
    if impl == "kernel" and not x.is_cuda:
        raise ValueError(
            f"impl='kernel' needs CUDA tensors, got a tensor on {x.device}"
        )
    return impl


def decode_attention(
    q, k_pages, v_pages, pos_pages, page_table, q_pos, *, scale,
    window: int = 0, softcap: float = 0.0, impl: str = "auto",
):
    """Flash-decode: single-query attention over a paged KV cache.

    ``q`` (B, H, d), pools (N, P, K, d) + (N, P) stored positions,
    ``page_table`` (B, C), ``q_pos`` (B,) (-1 = inactive slot -> zeros).
    """
    if resolve_impl(impl, q) == "ref":
        return ref.decode_attention_ref(
            q, k_pages, v_pages, pos_pages, page_table, q_pos,
            scale=scale, window=window, softcap=softcap,
        )
    # fold the scale into q, as the reference's ops.decode_attention does,
    # so the kernel's own scale stays 1 and the numerics match
    qs = (q.float() * scale).to(q.dtype)
    return da.flash_decode(
        qs, k_pages, v_pages, pos_pages, page_table, q_pos,
        scale=1.0, window=window, softcap=softcap,
    )


def fused_rmsnorm(x, gain, *, eps: float = 1e-6, impl: str = "auto"):
    if resolve_impl(impl, x) == "ref":
        return ref.rmsnorm_ref(x, gain, eps)
    return rn.rmsnorm(x.contiguous(), gain.float().contiguous(), eps)
