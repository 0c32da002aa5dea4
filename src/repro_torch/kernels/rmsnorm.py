"""Fused RMSNorm: the wrapper of the hand-written CUDA kernel.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``; the
source and its design note are ``csrc/rmsnorm.cu``.  The wrapper launches
the kernel on a CUDA tensor or raises; the plain version is
``kernels/ref.py::rmsnorm_ref``, chosen by ``kernels/ops.py`` for CPU
tensors.  Forward only: the backward kernel comes with training.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches in this process (reset by callers that count)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``y = x * rsqrt(mean(x^2) + eps) * (1 + gain)`` over the last dim.

    x: (..., D) float32 or bfloat16, contiguous, on the card; gain: (D,)
    float32.  Returns a new tensor shaped and typed like x.
    """
    global launches
    if not x.is_cuda:
        raise ValueError(f"rmsnorm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"rmsnorm kernel takes float32/bfloat16, got {x.dtype}")
    D = x.shape[-1]
    if gain.dtype != torch.float32 or tuple(gain.shape) != (D,):
        raise ValueError(
            f"rmsnorm kernel wants a float32 ({D},) gain, got "
            f"{gain.dtype} {tuple(gain.shape)}"
        )
    if gain.device != x.device:
        raise ValueError(f"gain on {gain.device}, x on {x.device}")
    if not (x.is_contiguous() and gain.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and gain")
    rows = x.numel() // max(D, 1)
    if rows >= 2**31 or D >= 2**31:
        raise ValueError(f"rmsnorm kernel: {rows} rows x {D} exceeds int32")
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
