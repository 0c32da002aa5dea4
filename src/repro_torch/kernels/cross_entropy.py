"""Chunked softmax cross-entropy: the wrappers of the hand-written CUDA kernels.

``ce_fwd`` (B3) replaces the TPU kernel
``repro/kernels/cross_entropy.py::_ce_fwd_kernel`` and ``ce_bwd`` (B4)
``_ce_bwd_kernel``; the sources and their design notes are in
``csrc/cross_entropy.cu``.  Each wrapper launches its kernel on CUDA tensors
or raises; the plain versions are ``kernels/ref.py::
softmax_cross_entropy_ref`` and ``softmax_cross_entropy_bwd_ref``, chosen by
``kernels/ops.py`` for CPU tensors, where ``softmax_cross_entropy`` wires
the pair into autograd.  Unlike the TPU kernel the CUDA one takes any V.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0   # B3 launches in this process (reset by callers that count)
bwd_launches = 0   # B4 launches


def _check(logits: torch.Tensor, labels: torch.Tensor, what: str):
    """(N, V) after the checks both kernels share."""
    for name, t in (("logits", logits), ("labels", labels)):
        if not t.is_cuda:
            raise ValueError(f"{what} kernel needs CUDA tensors; {name} is on "
                             f"{t.device}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous {name}")
    if logits.ndim != 2 or logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes (N, V) float32/bfloat16 logits, "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    N, V = logits.shape
    if labels.dtype != torch.int32 or tuple(labels.shape) != (N,):
        raise ValueError(f"{what} kernel wants ({N},) int32 labels, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if N >= 2**31 or V >= 2**31 or V == 0:
        raise ValueError(f"{what} kernel: logits {tuple(logits.shape)} out of range")
    return N, V


def ce_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """Per-row ``(loss, lse)``, both (N,) float32: ``lse = logsumexp(row)``
    and ``loss = lse - row[label]``.

    logits: (N, V) float32 or bfloat16; labels: (N,) int32 in [0, V) (a
    label outside that range matches no column, so its loss is lse).
    """
    global fwd_launches
    N, V = _check(logits, labels, "ce_fwd")
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    if N == 0:
        return loss, lse
    lib = build.library()
    err = lib.repro_ce_fwd(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        N, V, _DTYPE_CODES[logits.dtype],
        build.stream(logits),
    )
    build.check(err, "ce_fwd kernel")
    fwd_launches += 1
    return loss, lse


def ce_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
           g: torch.Tensor) -> torch.Tensor:
    """``dlogits = (exp(logits - lse) - onehot(label)) * g`` per row, shaped
    and typed like logits.  lse and g (the loss cotangent): (N,) float32."""
    global bwd_launches
    N, V = _check(logits, labels, "ce_bwd")
    for name, t in (("lse", lse), ("g", g)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N,) \
                or t.device != logits.device or not t.is_contiguous():
            raise ValueError(f"ce_bwd kernel wants a contiguous ({N},) float32 "
                             f"{name} on {logits.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (V + 1023) // 1024 > 65535:
        raise ValueError(f"ce_bwd kernel: V={V} needs more than 65535 chunks")
    dx = torch.empty_like(logits)
    if N == 0:
        return dx
    lib = build.library()
    err = lib.repro_ce_bwd(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), N, V, _DTYPE_CODES[logits.dtype],
        build.stream(logits),
    )
    build.check(err, "ce_bwd kernel")
    bwd_launches += 1
    return dx
