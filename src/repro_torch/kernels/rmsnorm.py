"""Fused RMSNorm: the wrappers of the hand-written CUDA kernels.

``rmsnorm`` (B1) replaces the TPU kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel`` and ``rmsnorm_bwd`` (B2)
``_rmsnorm_bwd_kernel``; the sources and their design notes are in
``csrc/rmsnorm.cu``.  Each wrapper launches its kernel on CUDA tensors or
raises; the plain versions are ``kernels/ref.py::rmsnorm_ref`` and
``rmsnorm_bwd_ref``, chosen by ``kernels/ops.py`` for CPU tensors, where
``fused_rmsnorm`` wires the pair into autograd.

B1 runs 61 times a serve forward on a few rows, where its call costs more
host time than the card spends on it; so its path is short: the library
without a lock once built, the stream's raw handle, and only the checks
the kernel needs, cheapest first.  B2 runs 17 times a train step, one
cooperative launch each: the rows, then, after a grid-wide barrier, dgain
summed over the blocks' partial sums in a fixed order.

Both take a gain per group as well: a (G, D) gain over rows that fall into
G equal contiguous groups (an HP sweep's candidates stacked on a leading
axis, ``ops``' vmap rule), still one launch; dgain is then (G, D), each
row summed over its own group.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0       # B1 launches in this process (reset by callers that count)
bwd_launches = 0   # B2 launches (one a call)
grouped_launches = 0       # B1 / B2 launches with a (G, D) gain, counted apart
bwd_grouped_launches = 0


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``y = x * rsqrt(mean(x^2) + eps) * (1 + gain)`` over the last dim.

    x: (..., D) float32 or bfloat16, contiguous, on the card; gain: (D,)
    float32, or (G, D) with x's rows in G equal groups (group i's rows
    take gain row i).  Returns a new tensor shaped and typed like x.
    """
    global launches, grouped_launches
    rows, D, groups, code = _check(x, gain, "rmsnorm")
    y = torch.empty_like(x)
    if rows == 0 or D == 0:
        return y
    if gain.ndim == 1:
        err = build.library().repro_rmsnorm(x.data_ptr(), gain.data_ptr(), y.data_ptr(),
                                            rows, D, eps, code, build.stream(x))
        build.check(err, "rmsnorm kernel")
        launches += 1
        return y
    err = build.library().repro_rmsnorm_grouped(
        x.data_ptr(), gain.data_ptr(), y.data_ptr(), rows, D, groups, eps, code,
        build.stream(x))
    build.check(err, "rmsnorm kernel (a gain per group)")
    grouped_launches += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradients of :func:`rmsnorm`: ``(dx, dgain)``.

    x, dy: (..., D) of one dtype (float32 or bfloat16), contiguous, on the
    card; gain: (D,) or (G, D) float32, as :func:`rmsnorm` takes it.  dx is
    shaped and typed like x; dgain is float32 shaped like gain, each row
    summed over its group's rows in a fixed order (deterministic).  One
    launch: the rows and dgain's sum over the partial sums of the kernel's
    virtual blocks (a scratch of one row each, none straddling two groups,
    allocated here on x's stream) in one cooperative grid.
    """
    global bwd_launches, bwd_grouped_launches
    rows, D, groups, code = _check(x, gain, "rmsnorm_bwd")
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
    n_blocks = lib.repro_rmsnorm_bwd_blocks(x.data_ptr(), gain.data_ptr(), dy.data_ptr(),
                                            dx.data_ptr(), rows, D, groups, code)
    if n_blocks < 1:
        build.check(-n_blocks, "rmsnorm_bwd kernel's grid")
    partial = torch.empty(n_blocks, D, dtype=torch.float32, device=x.device)
    dgain = torch.empty(gain.shape, dtype=torch.float32, device=x.device)
    err = lib.repro_rmsnorm_bwd(
        x.data_ptr(), gain.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgain.data_ptr(), partial.data_ptr(), n_blocks, rows, D, groups, float(eps),
        code, build.stream(x),
    )
    build.check(err, "rmsnorm_bwd kernel")
    if gain.ndim == 1:
        bwd_launches += 1
    else:
        bwd_grouped_launches += 1
    return dx, dgain


def _check(x: torch.Tensor, gain: torch.Tensor, what: str):
    """(rows, D, groups, dtype code) of x after the checks both kernels
    share: a CUDA x of a dtype they take, a float32 (D,) or (G, D) gain on
    x's card (G dividing the rows), both contiguous, and int32 sizes."""
    if not x.is_cuda:
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {x.dtype}")
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    groups = 1
    if gain.dtype != torch.float32 or gain.shape != (D,):
        groups = gain.shape[0] if gain.ndim == 2 else 0
        if gain.dtype != torch.float32 or gain.shape != (groups, D) or groups < 1 \
                or rows % groups:
            raise ValueError(
                f"{what} kernel wants a float32 ({D},) gain, or (G, {D}) with G "
                f"dividing the {rows} rows, got {gain.dtype} {tuple(gain.shape)}"
            )
    if gain.get_device() != x.get_device():
        raise ValueError(f"gain on {gain.device}, x on {x.device}")
    if not (x.is_contiguous() and gain.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous x and gain")
    if rows >= 2**31 or D >= 2**31:
        raise ValueError(f"{what} kernel: {rows} rows x {D} exceeds int32")
    return rows, D, groups, code
