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

The differentiable ops (``fused_rmsnorm``, ``softmax_cross_entropy``,
``attention``) are ``torch.autograd.Function``s whose forward and backward
follow the same choice: on the card the backward is a kernel too.
``attention_plain_flash`` is attention's kernel path over the plain
versions of its kernels, for holding a model that runs them against one
that rounds where they round.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
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


def _scales_fit(k_pages, k_scale, v_scale):
    """Raise unless int8 pools come with both scales and other pools with
    none."""
    given = (k_scale is not None, v_scale is not None)
    if k_pages.dtype == torch.int8:
        if given != (True, True):
            raise ValueError("int8 pools need k_scale and v_scale, (N, K) float32")
    elif any(given):
        raise ValueError(f"k_scale/v_scale go with int8 pools, got {k_pages.dtype} pools")


def decode_attention(
    q, k_pages, v_pages, pos_pages, page_table, q_pos, *, scale,
    window: int = 0, softcap: float = 0.0, k_scale=None, v_scale=None,
    impl: str = "auto",
):
    """Flash-decode: single-query attention over a paged KV cache.

    ``q`` (B, H, d), pools (N, P, K, d) + (N, P) stored positions,
    ``page_table`` (B, C), ``q_pos`` (B,) (-1 = inactive slot -> zeros).
    With ``k_scale``/``v_scale`` ((N, K) f32) the pools hold int8 bytes,
    dequantized by their per-page-per-head scales (in the kernel as it
    stages a page; after the gather in the plain version).
    """
    _scales_fit(k_pages, k_scale, v_scale)
    if resolve_impl(impl, q) == "ref":
        return ref.decode_attention_ref(
            q, k_pages, v_pages, pos_pages, page_table, q_pos,
            scale=scale, window=window, softcap=softcap,
            k_scale=k_scale, v_scale=v_scale,
        )
    # fold the scale into q, as the reference's ops.decode_attention does,
    # so the kernel's own scale stays 1 and the numerics match
    qs = (q.float() * scale).to(q.dtype)
    return da.flash_decode(
        qs, k_pages, v_pages, pos_pages, page_table, q_pos,
        scale=1.0, window=window, softcap=softcap,
        k_scale=k_scale, v_scale=v_scale,
    )


def decode_attention_multi(
    q, k_pages, v_pages, pos_pages, page_table, q_pos, *, scale,
    window: int = 0, softcap: float = 0.0, k_scale=None, v_scale=None,
    impl: str = "auto",
):
    """Multi-query flash-decode: a T-token chunk per slot attends over the
    paged KV cache (chunked prefill, prefix-cache suffixes, speculative
    verify).

    ``q`` (B, T, H, d), pools (N, P, K, d) + (N, P) stored positions,
    ``page_table`` (B, C), ``q_pos`` (B, T) per-query positions (-1 rows ->
    zeros).  The chunk must already be written into the pages; per-row
    position masking then gives history visibility and causality within
    the chunk.  ``k_scale``/``v_scale`` select the int8 pools, as in
    :func:`decode_attention`.
    """
    _scales_fit(k_pages, k_scale, v_scale)
    if resolve_impl(impl, q) == "ref":
        return ref.decode_attention_multi_ref(
            q, k_pages, v_pages, pos_pages, page_table, q_pos,
            scale=scale, window=window, softcap=softcap,
            k_scale=k_scale, v_scale=v_scale,
        )
    # the scale folded into q, as the reference's ops.decode_attention_multi
    # does
    qs = (q.float() * scale).to(q.dtype)
    return da.flash_decode_multi(
        qs, k_pages, v_pages, pos_pages, page_table, q_pos,
        scale=1.0, window=window, softcap=softcap,
        k_scale=k_scale, v_scale=v_scale,
    )


def launch_counts() -> dict:
    """Kernel launches counted by the wrappers in this process (B2 counts
    one per backward call; B8 and B9 count their int8-pool launches, B5-B7
    their int8-operand launches, apart from their f32/bf16 ones)."""
    return {
        "rmsnorm": rn.launches, "rmsnorm_bwd": rn.bwd_launches,
        "ce_fwd": ce.fwd_launches, "ce_bwd": ce.bwd_launches,
        "flash_decode": da.launches, "flash_decode_multi": da.multi_launches,
        "flash_decode_int8": da.int8_launches,
        "flash_decode_multi_int8": da.multi_int8_launches,
        "flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.dq_launches,
        "flash_bwd_dkv": fa.dkv_launches,
        "flash_fwd_int8": fa.fwd_int8_launches,
        "flash_bwd_dq_int8": fa.dq_int8_launches,
        "flash_bwd_dkv_int8": fa.dkv_int8_launches,
    }


def reset_launch_counts() -> None:
    rn.launches = rn.bwd_launches = 0
    ce.fwd_launches = ce.bwd_launches = 0
    da.launches = da.multi_launches = 0
    da.int8_launches = da.multi_int8_launches = 0
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.fwd_int8_launches = fa.dq_int8_launches = fa.dkv_int8_launches = 0


class _RMSNorm(torch.autograd.Function):
    """B1 forward, B2 backward (or their plain versions).  Saves only
    ``(x, gain)``: the backward recomputes the row's rsqrt, as the TPU
    kernel's custom_vjp does."""

    @staticmethod
    def forward(ctx, x, gain, eps, kernel):
        ctx.save_for_backward(x, gain)
        ctx.eps, ctx.kernel = eps, kernel
        if kernel:
            return rn.rmsnorm(x, gain.float().contiguous(), eps)
        return ref.rmsnorm_ref(x, gain, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        if ctx.kernel:
            dx, dgain = rn.rmsnorm_bwd(x, gain.float().contiguous(),
                                       dy.contiguous(), ctx.eps)
        else:
            dx, dgain = ref.rmsnorm_bwd_ref(x, gain, dy, ctx.eps)
        # dgain in the gain's dtype, as the reference's custom_vjp returns it
        return dx, dgain.to(gain.dtype), None, None


def fused_rmsnorm(x, gain, *, eps: float = 1e-6, impl: str = "auto"):
    """RMSNorm with the ``(1 + gain)`` convention, differentiable in x and
    gain."""
    kernel = resolve_impl(impl, x) == "kernel"
    if kernel:
        x = x.contiguous()
    return _RMSNorm.apply(x, gain, eps, kernel)


class _SoftmaxXent(torch.autograd.Function):
    """B3 forward, B4 backward (or their plain versions) over (N, V) logits
    and (N,) clamped int32 labels.  The residuals are the logits, the labels
    and the (N,) lse; labels get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, kernel):
        if kernel:
            loss, lse = ce.ce_fwd(logits, labels)
        else:
            loss, lse = ref.softmax_cross_entropy_ref(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.kernel = kernel
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.kernel:
            dlogits = ce.ce_bwd(logits, labels, lse, g)
        else:
            dlogits = ref.softmax_cross_entropy_bwd_ref(logits, labels, lse, g)
        return dlogits, None, None


def softmax_cross_entropy(logits, labels, *, impl: str = "auto"):
    """Per-position softmax CE, float32, shaped ``logits.shape[:-1]``.

    Negative (masked) labels are clamped to [0, V), as the reference's
    ``cross_entropy`` does; the caller applies its own mask to the returned
    losses, so masked rows get a zero cotangent and their dlogits vanish.
    The CUDA kernels take any V: there is no shape rule to fall back on.
    """
    kernel = resolve_impl(impl, logits) == "kernel"
    V = logits.shape[-1]
    x2 = logits.reshape(-1, V)
    lab2 = labels.reshape(-1).clamp(0, V - 1).to(torch.int32)
    if kernel:
        x2 = x2.contiguous()
    return _SoftmaxXent.apply(x2, lab2, kernel).reshape(logits.shape[:-1])


class _FlashAttention(torch.autograd.Function):
    """The flash forward, then its backward from ``(q, k, v, o, lse)``: the
    backward recomputes p from lse, never saving an (S, T) matrix.  ``fwd``
    and ``bwd`` are B5 and B6 + B7 (:func:`_kernel_bwd`), or their plain
    versions at the same contract."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, policy, fwd, bwd):
        kw = dict(causal=causal, window=window, softcap=softcap, policy=policy)
        o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        ctx.bwd = bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # softmax-jacobian correction rowsum(do * o), laid out (B, H, S) like
        # lse, in plain torch between the kernels as the reference does it
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = ctx.bwd(q, k, v, do, lse, delta, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def _kernel_bwd(q, k, v, do, lse, delta, **kw):
    """(dq, dk, dv) from B6 and B7."""
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


def attention(q, k, v, *, scale, causal: bool = True, window: int = 0,
              softcap: float = 0.0, impl: str = "auto", policy=None):
    """Flash attention with GQA / causal / sliding window / softcap,
    differentiable in q, k and v.

    q (B, S, H, d), k and v (B, T, K, d); returns (B, S, H, d) in q's dtype.
    ``policy`` (a quant.QuantPolicy or None) selects the tile-matmul
    precision; an inactive one is None.  The kernel path folds ``scale``
    into q outside the autograd Function (the kernels' own scale is 1), as
    the reference does; the plain path applies it to the logits.  The CUDA
    kernels take any S and T: there is no shape rule to fall back on.
    """
    if policy is not None and not policy.active:
        policy = None
    if resolve_impl(impl, q) == "ref":
        if policy is not None:
            return ref.attention_policy_ref(
                q, k, v, scale=scale, causal=causal, window=window,
                softcap=softcap, policy=policy,
            )
        return ref.attention_ref(q, k, v, scale=scale, causal=causal,
                                 window=window, softcap=softcap)
    return _flash(q, k, v, scale, causal, window, softcap, policy,
                  fa.flash_fwd, _kernel_bwd)


def attention_plain_flash(q, k, v, *, scale, causal: bool = True,
                          window: int = 0, softcap: float = 0.0, policy=None):
    """The kernel path of :func:`attention` with B5-B7 replaced by their
    plain versions at the kernels' contract (``ref.flash_fwd_ref``,
    ``ref.flash_bwd_ref``): the same scale fold, delta and casts, and the
    bf16 rounding or int8 quantization, tile by tile, where the kernels do
    it.  Launches nothing, on any device.
    """
    if policy is not None and not policy.active:
        policy = None
    return _flash(q, k, v, scale, causal, window, softcap, policy,
                  ref.flash_fwd_ref, ref.flash_bwd_ref)


def _flash(q, k, v, scale, causal, window, softcap, policy, fwd, bwd):
    qs = (q.float() * scale).to(q.dtype).contiguous()
    return _FlashAttention.apply(qs, k.contiguous(), v.contiguous(), causal,
                                 window, softcap, policy, fwd, bwd)
