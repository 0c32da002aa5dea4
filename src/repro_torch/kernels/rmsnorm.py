"""Fused RMSNorm: the wrappers of the hand-written CUDA kernels.

``rmsnorm`` (B1) replaces the TPU kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel`` and ``rmsnorm_bwd`` (B2)
``_rmsnorm_bwd_kernel``; the sources and their design notes are in
``csrc/rmsnorm.cu``.  Each wrapper launches its kernel on CUDA tensors or
raises; the plain versions are ``kernels/ref.py::rmsnorm_ref`` and
``rmsnorm_bwd_ref``, chosen by ``kernels/ops.py`` for CPU tensors, where
``fused_rmsnorm`` wires the pair into autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0       # B1 launches in this process (reset by callers that count)
bwd_launches = 0   # B2 calls (two launches each: rows, then the dgain sum)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``y = x * rsqrt(mean(x^2) + eps) * (1 + gain)`` over the last dim.

    x: (..., D) float32 or bfloat16, contiguous, on the card; gain: (D,)
    float32.  Returns a new tensor shaped and typed like x.
    """
    global launches
    rows, D = _check(x, gain, "rmsnorm")
    y = torch.empty_like(x)
    if rows == 0 or D == 0:
        return y
    lib = build.library()
    err = lib.repro_rmsnorm(
        x.data_ptr(), gain.data_ptr(), y.data_ptr(), rows, D, float(eps),
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm kernel")
    launches += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradients of :func:`rmsnorm`: ``(dx, dgain)``.

    x, dy: (..., D) of one dtype (float32 or bfloat16), contiguous, on the
    card; gain: (D,) float32.  dx is shaped and typed like x; dgain is
    (D,) float32, summed over every row in a fixed order (deterministic).
    """
    global bwd_launches
    rows, D = _check(x, gain, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(
            f"rmsnorm_bwd kernel wants a contiguous dy like x {tuple(x.shape)} "
            f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}"
        )
    dx = torch.empty_like(x)
    if rows == 0 or D == 0:
        return dx, torch.zeros_like(gain)
    lib = build.library()
    n_blocks = lib.repro_rmsnorm_bwd_blocks(rows, D)
    partial = torch.empty(n_blocks, D, dtype=torch.float32, device=x.device)
    dgain = torch.empty(D, dtype=torch.float32, device=x.device)
    err = lib.repro_rmsnorm_bwd(
        x.data_ptr(), gain.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgain.data_ptr(), partial.data_ptr(), n_blocks, rows, D, float(eps),
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm_bwd kernel")
    bwd_launches += 1
    return dx, dgain


def _check(x: torch.Tensor, gain: torch.Tensor, what: str):
    """(rows, D) of x after the checks both kernels share."""
    if not x.is_cuda:
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {x.dtype}")
    D = x.shape[-1]
    if gain.dtype != torch.float32 or tuple(gain.shape) != (D,):
        raise ValueError(
            f"{what} kernel wants a float32 ({D},) gain, got "
            f"{gain.dtype} {tuple(gain.shape)}"
        )
    if gain.device != x.device:
        raise ValueError(f"gain on {gain.device}, x on {x.device}")
    if not (x.is_contiguous() and gain.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous x and gain")
    rows = x.numel() // max(D, 1)
    if rows >= 2**31 or D >= 2**31:
        raise ValueError(f"{what} kernel: {rows} rows x {D} exceeds int32")
    return rows, D
