"""Flash attention forward, dq and dk/dv: the wrappers of the hand-written
CUDA kernels.

``flash_fwd`` (B5) replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``, ``flash_bwd_dq`` (B6)
``_flash_bwd_dq_kernel`` and ``flash_bwd_dkv`` (B7)
``_flash_bwd_dkv_kernel``, in the f32, bf16 and int8 operand modes of the
mixed-precision policy; the source and its design note are
``csrc/flash_attention.cu``.  Which kernel serves which mode: in the bf16
mode (``train --amp bf16``) all three run on the tensor cores
(``flash_fwd_tc_kernel``, ``flash_bwd_dq_tc_kernel``,
``flash_bwd_dkv_tc_kernel``: mma.sync, ldmatrix, TMA boxes on an
mbarrier); in the f32 mode on FFMA
(``flash_fwd_kernel``, ``flash_bwd_dq_kernel``, ``flash_bwd_dkv_kernel``);
in the int8 mode each direction in two steps.  The forward: a pre-pass
(:func:`quantize_fwd`, ``flash_quant_fwd_i8_kernel``) quantizes k per row
over d and v per column over each 128-key tile once a call, and B5
(``flash_fwd_i8_kernel``) quantizes q per row at each item's set-up and p
in registers.  The backward: a pre-pass (:func:`quantize_bwd`,
``flash_quant_i8_kernel``) quantizes q, k, v and do once a call, per row
over d and per column over each 128-row tile, and B6 and B7
(``flash_bwd_dq_i8_kernel``, ``flash_bwd_dkv_i8_kernel``) quantize p and
ds in registers.  The column tiles are stored K-major in the MMA
fragments' order (``ref.FRAG_PERM``), and all three multiply the bytes on
the s8 tensor cores (mma.sync m16n8k32).  Each int8 product is exact and
its int32 sum cannot overflow, so the MMA's order and the permutation
change no bit: the kernels keep the scales' axes and the f32 steps of the
dp4a kernels they replace, in order; B5 sums l in the fragments' order,
as its plain version does.
:func:`flash_fwd` runs the forward pre-pass and B5 in the int8 mode;
:func:`flash_bwd` runs the backward as ``ops.attention`` wants it (one
pre-pass for B6 and B7 in the int8 mode); ``flash_bwd_dq`` and
``flash_bwd_dkv`` each run the pre-pass themselves.  Each wrapper launches
its kernels on CUDA tensors or raises: nothing falls back to another
kernel.  Their plain versions at this contract, rounding where the kernels
round, are ``kernels/ref.py::flash_fwd_ref`` and ``flash_bwd_ref`` (the
pre-passes': ``flash_quant_fwd_ref``, ``flash_quant_bwd_ref``), which walk the same tiles
(``ref.FLASH_TILES``: B5's 128-key tiles and, in the int8 mode, where the
tiles carry the scales, B6's 128-key and B7's 128-query tiles);
``kernels/ops.py::attention`` wires the kernels into a
``torch.autograd.Function`` and, for CPU tensors, runs the plain attention
(``attention_ref`` / ``attention_policy_ref``) under autograd instead.  Any
S and T: the kernels mask their ragged last tile.  d_head 1 to 256
(``MAX_D_HEAD``), zero-padded to DP = 64, 128 or 256 (:func:`padded_d`); at
DP 256 (gemma2's heads) the bf16 and int8 kernels' grids, and B7's in the
f32 mode, split the output's d columns in two halves of 128, each block
forming the whole score tile over d; a wider head raises.  Under an HP
sweep's ``torch.func.vmap`` ``ops.attention`` folds the candidate axis into
B, one launch of each kernel for all N candidates (each (batch row, head)
owns its tiles and its int8 scales, so the fold changes no bit);
:func:`check_candidates` refuses a fold past the grid's or int32
indexing's limits, naming the candidate count.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import MAX_D_HEAD, padded_d

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "bf16": 1, "int8": 2}

fwd_launches = 0   # B5 launches in this process (reset by callers that count)
dq_launches = 0    # B6
dkv_launches = 0   # B7
fwd_int8_launches = 0   # the same three in the int8 operand mode, apart
dq_int8_launches = 0
dkv_int8_launches = 0
quant_int8_launches = 0   # the int8 backward's pre-pass
fwd_quant_int8_launches = 0   # the int8 forward's pre-pass

# the pre-pass's outputs, in the order of the C side's I8Ops
I8_FIELDS = ("q8", "do8", "k8", "v8", "kT8", "qT8", "doT8",
             "sq", "sdo", "sk", "sv", "skc", "sqc", "sdoc")
# the forward pre-pass's outputs, in the order of the C side's FwdI8Ops
FWD_I8_FIELDS = ("k8", "vT8", "sk", "svc")
I8_TILE = 128   # the rows of a tile whose columns share a scale


def _mode_code(policy) -> int:
    return _MODES[getattr(policy, "matmul", "none") if policy is not None else "none"]


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
    if not _fits(B, H, q.numel(), k.numel()):
        raise ValueError(f"{what} kernel: sizes exceed its grid or int32 indexing")
    return B, S, T, H, K, d


def _fits(B, H, q_numel, k_numel) -> bool:
    """B and H within the grid's 65,535, q's and k's sizes within int32."""
    return B <= 65535 and H <= 65535 and q_numel < 2**31 and k_numel < 2**31


def check_candidates(n, q_shape, k_shape) -> None:
    """Raise unless ``n`` candidates of q ``q_shape`` (B, S, H, d) and k, v
    ``k_shape`` (B, T, K, d), folded into one batch of n * B (what
    ``ops.attention`` does under ``torch.func.vmap``), fit the kernels'
    grid and int32 indexing.  Nothing splits a fold over several launches
    or falls back to the plain version: the sweep takes fewer candidates."""
    B, H = q_shape[0], q_shape[2]
    qn, kn = n * math.prod(q_shape), n * math.prod(k_shape)
    if not _fits(n * B, H, qn, kn):
        raise ValueError(
            f"flash attention over {n} candidates: the folded batch {n} x {B} = {n * B} "
            f"(q {qn:,} and k {kn:,} elements) exceeds the kernels' grid (65,535) or "
            f"int32 indexing (2**31); sweep fewer candidates at once")


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


def _tail(scale, causal, window, softcap, policy, q):
    return (float(scale), int(bool(causal)), int(window), float(softcap),
            _mode_code(policy), _DTYPE_CODES[q.dtype], build.stream(q))


def flash_fwd(q, k, v, *, scale: float = 1.0, causal: bool = True,
              window: int = 0, softcap: float = 0.0, policy=None):
    """Flash attention forward (B5): ``(o, lse)``.

    q (B, S, H, d), k and v (B, T, K, d), one dtype (float32 or bfloat16),
    contiguous, on the card; query head h reads kv head h // (H // K).
    o is (B, S, H, d) in q's dtype, lse (B, H, S) float32.  ``policy`` (a
    quant.QuantPolicy or None) selects f32, bf16 or int8 tile-matmul
    operands; in the int8 mode the call runs the forward pre-pass
    (:func:`quantize_fwd`) first.
    """
    global fwd_launches, fwd_int8_launches
    B, S, T, H, K, d = _check("flash_fwd", q, k, v)
    tail = _tail(scale, causal, window, softcap, policy, q)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if tail[4] == _MODES["int8"]:
        ops = quantize_fwd(k, v)
        err = build.library().repro_flash_fwd_i8(
            q.data_ptr(), _i8_array(ops, FWD_I8_FIELDS), o.data_ptr(), lse.data_ptr(),
            B, S, T, H, K, d, *tail[:4], *tail[5:])
        build.check(err, "flash_fwd_i8 kernel")
        fwd_int8_launches += 1
        return o, lse
    err = build.library().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, T, H, K, d, *tail)
    build.check(err, "flash_fwd kernel")
    fwd_launches += 1
    return o, lse


def i8_shapes(B, S, T, H, K, d) -> dict:
    """{name: (shape, dtype)} of the pre-pass's outputs (``I8_FIELDS``):
    q and do per row over d, (B, S, H, DP) int8 with (B, H, S) scales; k
    and v per key over d, (B, T, K, DP) with (B, K, T); k per column over
    each 128-key tile, K-major, (B, K, nT, DP, 128) with (B, K, nT, DP); q
    and do likewise over each 128-query tile, (B, H, nS, DP, 128) with (B,
    H, nS, DP)."""
    DP, nS, nT = padded_d(d), -(-S // I8_TILE), -(-T // I8_TILE)
    i8, f32 = torch.int8, torch.float32
    return {"q8": ((B, S, H, DP), i8), "do8": ((B, S, H, DP), i8),
            "k8": ((B, T, K, DP), i8), "v8": ((B, T, K, DP), i8),
            "kT8": ((B, K, nT, DP, I8_TILE), i8), "qT8": ((B, H, nS, DP, I8_TILE), i8),
            "doT8": ((B, H, nS, DP, I8_TILE), i8),
            "sq": ((B, H, S), f32), "sdo": ((B, H, S), f32),
            "sk": ((B, K, T), f32), "sv": ((B, K, T), f32),
            "skc": ((B, K, nT, DP), f32), "sqc": ((B, H, nS, DP), f32),
            "sdoc": ((B, H, nS, DP), f32)}


def fwd_i8_shapes(B, T, K, d) -> dict:
    """{name: (shape, dtype)} of the forward pre-pass's outputs
    (``FWD_I8_FIELDS``): k per key over d, (B, T, K, DP) int8 with (B, K,
    T) scales (the backward's k8 and sk); v per column over each 128-key
    tile, K-major, (B, K, nT, DP, 128) with (B, K, nT, DP) (the layout of
    the backward's kT8)."""
    DP, nT = padded_d(d), -(-T // I8_TILE)
    i8, f32 = torch.int8, torch.float32
    return {"k8": ((B, T, K, DP), i8), "vT8": ((B, K, nT, DP, I8_TILE), i8),
            "sk": ((B, K, T), f32), "svc": ((B, K, nT, DP), f32)}


def _i8_array(ops, fields=I8_FIELDS):
    return (ctypes.c_void_p * len(fields))(*(ops[n].data_ptr() for n in fields))


def quantize_fwd(k, v) -> dict:
    """The int8 forward's pre-pass (``flash_quant_fwd_i8_kernel``): k per
    key over d and v per column over each 128-key tile, quantized once, into
    fresh tensors named by ``FWD_I8_FIELDS``, shaped by
    :func:`fwd_i8_shapes` (``quant.quantize_int8``'s scales and bytes).
    Its plain version is ``ref.flash_quant_fwd_ref``."""
    global fwd_quant_int8_launches
    B, _, T, _, K, d = _check("flash_quant_fwd_i8", k, k, v)   # k stands in for q
    ops = {n: torch.empty(shape, dtype=dt, device=k.device)
           for n, (shape, dt) in fwd_i8_shapes(B, T, K, d).items()}
    err = build.library().repro_flash_quant_fwd_i8(
        k.data_ptr(), v.data_ptr(), _i8_array(ops, FWD_I8_FIELDS), B, T, K, d,
        _DTYPE_CODES[k.dtype], build.stream(k))
    build.check(err, "flash_quant_fwd_i8 kernel")
    fwd_quant_int8_launches += 1
    return ops


def quantize_bwd(q, k, v, do) -> dict:
    """The int8 backward's pre-pass (``flash_quant_i8_kernel``): q, k, v and
    do quantized once, into fresh tensors named by ``I8_FIELDS``, shaped by
    :func:`i8_shapes` (absmax / 127 scales, bytes rounded half to even and
    clipped to +-127, as ``quant.quantize_int8``).  Its plain version is
    ``ref.flash_quant_bwd_ref``."""
    global quant_int8_launches
    B, S, T, H, K, d = _check("flash_quant_i8", q, k, v, (("do", do),))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be like q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    ops = {n: torch.empty(shape, dtype=dt, device=q.device)
           for n, (shape, dt) in i8_shapes(B, S, T, H, K, d).items()}
    err = build.library().repro_flash_quant_i8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _i8_array(ops),
        B, S, T, H, K, d, _DTYPE_CODES[q.dtype], build.stream(q))
    build.check(err, "flash_quant_i8 kernel")
    quant_int8_launches += 1
    return ops


def _dq_i8(ops, q, lse, delta, dims, tail):
    global dq_int8_launches
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_bwd_dq_i8(
        _i8_array(ops), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
        *tail[:4], tail[6])
    build.check(err, "flash_bwd_dq_i8 kernel")
    dq_int8_launches += 1
    return dq


def _dkv_i8(ops, k, lse, delta, dims, tail):
    global dkv_int8_launches
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    err = build.library().repro_flash_bwd_dkv_i8(
        _i8_array(ops), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims, *tail[:4], tail[6])
    build.check(err, "flash_bwd_dkv_i8 kernel")
    dkv_int8_launches += 1
    return dk, dv


def flash_bwd(q, k, v, do, lse, delta, *, scale: float = 1.0, causal: bool = True,
              window: int = 0, softcap: float = 0.0, policy=None):
    """``(dq, dk, dv)``: B6 and B7 as ``ops.attention``'s backward runs them.
    In the int8 mode one pre-pass (:func:`quantize_bwd`) feeds both; in the
    others each kernel reads q, k, v and do itself.  Inputs and outputs as
    :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`."""
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap, policy=policy)
    if _mode_code(policy) != _MODES["int8"]:
        return (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    dims = _check_bwd("flash_bwd", q, k, v, do, lse, delta)
    tail = _tail(scale, causal, window, softcap, policy, q)
    ops = quantize_bwd(q, k, v, do)
    return (_dq_i8(ops, q, lse, delta, dims, tail), *_dkv_i8(ops, k, lse, delta, dims, tail))


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float = 1.0,
                 causal: bool = True, window: int = 0, softcap: float = 0.0,
                 policy=None):
    """dq (B6), float32 (B, S, H, d), recomputing p = exp(s - lse) per tile.

    ``do`` is shaped and typed like q; ``lse`` and ``delta`` = rowsum(do * o)
    are float32 (B, H, S).  In the int8 mode the call runs the pre-pass
    (:func:`quantize_bwd`) first.
    """
    global dq_launches
    dims = _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    tail = _tail(scale, causal, window, softcap, policy, q)
    if tail[4] == _MODES["int8"]:
        return _dq_i8(quantize_bwd(q, k, v, do), q, lse, delta, dims, tail)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *dims, *tail)
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
    dims = _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    tail = _tail(scale, causal, window, softcap, policy, q)
    if tail[4] == _MODES["int8"]:
        return _dkv_i8(quantize_bwd(q, k, v, do), k, lse, delta, dims, tail)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims, *tail)
    build.check(err, "flash_bwd_dkv kernel")
    dkv_launches += 1
    return dk, dv
