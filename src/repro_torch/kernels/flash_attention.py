"""Flash attention forward, dq and dk/dv: the wrappers of the hand-written
CUDA kernels.

``flash_fwd`` (B5) replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``, ``flash_bwd_dq`` (B6)
``_flash_bwd_dq_kernel`` and ``flash_bwd_dkv`` (B7)
``_flash_bwd_dkv_kernel``, in the f32 and bf16 operand modes of the
mixed-precision policy; the source and its design note are
``csrc/flash_attention.cu``.  Each wrapper launches its kernel on CUDA
tensors or raises.  Their plain versions at this contract, rounding where
the kernels round, are ``kernels/ref.py::flash_fwd_ref`` and
``flash_bwd_ref``; ``kernels/ops.py::attention`` wires the kernels into a
``torch.autograd.Function`` and, for CPU tensors, runs the plain attention
(``attention_ref`` / ``attention_policy_ref``) under autograd instead.  Any
S and T: the kernels mask their ragged last tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "bf16": 1}
MAX_D_HEAD = 128

fwd_launches = 0   # B5 launches in this process (reset by callers that count)
dq_launches = 0    # B6
dkv_launches = 0   # B7


def _mode_code(policy) -> int:
    mode = getattr(policy, "matmul", "none") if policy is not None else "none"
    if mode not in _MODES:
        raise NotImplementedError(
            f"flash attention kernels: operand mode {mode!r} is not ported yet "
            f"(ported: {sorted(_MODES)}); int8 comes with the int8 slice of B5-B7"
        )
    return _MODES[mode]


def _check(what, q, k, v, extra=()):
    """(B, S, T, H, K, d) after the checks the three kernels share."""
    named = (("q", q), ("k", k), ("v", v)) + tuple(extra)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{what} kernel needs CUDA tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous {name}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, S, H, d) and k, v (B, T, K, d), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != d or 0 in (B, S, T, K)
            or H % K):
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not 0 < d <= MAX_D_HEAD:
        raise ValueError(f"{what} kernel takes d_head up to {MAX_D_HEAD}, got {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if B > 65535 or H > 65535 or q.numel() >= 2**31 or k.numel() >= 2**31:
        raise ValueError(f"{what} kernel: sizes exceed its grid or int32 indexing")
    return B, S, T, H, K, d


def _check_bwd(what, q, k, v, do, lse, delta):
    """_check plus the backward's own inputs: do like q, lse and delta
    contiguous float32 (B, H, S)."""
    B, S, T, H, K, d = _check(what, q, k, v, (("do", do),))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be like q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what} kernel wants a contiguous float32 {name} "
                             f"({B}, {H}, {S}) on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return B, S, T, H, K, d


def _tail(scale, causal, window, softcap, policy, dtype, device):
    return (float(scale), int(bool(causal)), int(window), float(softcap),
            _mode_code(policy), _DTYPE_CODES[dtype],
            torch.cuda.current_stream(device).cuda_stream)


def flash_fwd(q, k, v, *, scale: float = 1.0, causal: bool = True,
              window: int = 0, softcap: float = 0.0, policy=None):
    """Flash attention forward (B5): ``(o, lse)``.

    q (B, S, H, d), k and v (B, T, K, d), one dtype (float32 or bfloat16),
    contiguous, on the card; query head h reads kv head h // (H // K).
    o is (B, S, H, d) in q's dtype, lse (B, H, S) float32.  ``policy`` (a
    quant.QuantPolicy or None) selects f32 or bf16 tile-matmul operands.
    """
    global fwd_launches
    B, S, T, H, K, d = _check("flash_fwd", q, k, v)
    tail = _tail(scale, causal, window, softcap, policy, q.dtype, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, T, H, K, d, *tail)
    build.check(err, "flash_fwd kernel")
    fwd_launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float = 1.0,
                 causal: bool = True, window: int = 0, softcap: float = 0.0,
                 policy=None):
    """dq (B6), float32 (B, S, H, d), recomputing p = exp(s - lse) per tile.

    ``do`` is shaped and typed like q; ``lse`` and ``delta`` = rowsum(do * o)
    are float32 (B, H, S).
    """
    global dq_launches
    B, S, T, H, K, d = _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    tail = _tail(scale, causal, window, softcap, policy, q.dtype, q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, S, T, H, K, d, *tail)
    build.check(err, "flash_bwd_dq kernel")
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float = 1.0,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  policy=None):
    """``(dk, dv)`` (B7), float32 (B, T, K, d), each summed over the G query
    heads of its group inside one block in a fixed order (no atomics: a
    repeated call gives the same bits).  Inputs as :func:`flash_bwd_dq`.
    """
    global dkv_launches
    B, S, T, H, K, d = _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    tail = _tail(scale, causal, window, softcap, policy, q.dtype, q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, T, H, K, d, *tail)
    build.check(err, "flash_bwd_dkv kernel")
    dkv_launches += 1
    return dk, dv
