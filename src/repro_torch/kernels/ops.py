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

Under ``torch.func.vmap`` (an HP sweep's candidates, stacked on a leading
axis: core/tuning.py), B1-B7's Functions run through their ``vmap`` rules,
the counterpart of ``jax.vmap`` turning a ``pallas_call`` into a grid axis:
each unwraps the batch to its physical tensors and makes *one* call for all
N candidates, which autograd then records as an ordinary node, so one
``.backward()`` outside the vmap runs B2 and B4 once for all N as well.
RMSNorm gets a gain per candidate (a (N, D) gain over N groups of rows);
the cross entropy folds the candidate axis into its rows, flash attention
into its batch (B5, and in the int8 mode its pre-pass, once a layer for
all N; B6, B7 and the int8 backward's pre-pass once in the backward).
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
_transforms_active = torch._C._are_functorch_transforms_active   # vmap and kin


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
    one per backward call; B1 and B2 count their launches with a gain per
    group (a sweep's candidates) apart; B8 and B9 count their int8-pool
    launches, B5-B7 their int8-operand launches, apart from their f32/bf16
    ones;
    ``flash_bwd_quant_int8`` and ``flash_fwd_quant_int8`` are the int8
    backward's and forward's pre-passes)."""
    return {
        "rmsnorm": rn.launches, "rmsnorm_bwd": rn.bwd_launches,
        "rmsnorm_grouped": rn.grouped_launches,
        "rmsnorm_bwd_grouped": rn.bwd_grouped_launches,
        "ce_fwd": ce.fwd_launches, "ce_bwd": ce.bwd_launches,
        "flash_decode": da.launches, "flash_decode_multi": da.multi_launches,
        "flash_decode_int8": da.int8_launches,
        "flash_decode_multi_int8": da.multi_int8_launches,
        "flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.dq_launches,
        "flash_bwd_dkv": fa.dkv_launches,
        "flash_fwd_int8": fa.fwd_int8_launches,
        "flash_bwd_dq_int8": fa.dq_int8_launches,
        "flash_bwd_dkv_int8": fa.dkv_int8_launches,
        "flash_bwd_quant_int8": fa.quant_int8_launches,
        "flash_fwd_quant_int8": fa.fwd_quant_int8_launches,
    }


def reset_launch_counts() -> None:
    rn.launches = rn.bwd_launches = 0
    rn.grouped_launches = rn.bwd_grouped_launches = 0
    ce.fwd_launches = ce.bwd_launches = 0
    da.launches = da.multi_launches = 0
    da.int8_launches = da.multi_int8_launches = 0
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.fwd_int8_launches = fa.dq_int8_launches = fa.dkv_int8_launches = 0
    fa.quant_int8_launches = fa.fwd_quant_int8_launches = 0


class _RMSNorm(torch.autograd.Function):
    """B1 forward, B2 backward (or their plain versions).  Saves only
    ``(x, gain)``: the backward recomputes the row's rsqrt, as the TPU
    kernel's custom_vjp does.  ``gain`` is (D,), or (G, D) over x's rows in
    G equal groups (what the vmap rule hands it)."""

    @staticmethod
    def forward(ctx, x, gain, eps, kernel):
        _RMSNormVmap.setup_context(ctx, (x, gain, eps, kernel), None)
        return _RMSNormVmap.forward(x, gain, eps, kernel)

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


class _RMSNormVmap(_RMSNorm):
    """:class:`_RMSNorm` under ``torch.func`` transforms, which need the
    ``setup_context`` form; its binding cost ~25 µs of host time a call
    (``scripts/torch_rmsnorm_host_probe.py`` beside an NVIDIA H100 80GB
    HBM3 at 700 W), so calls outside a transform keep the ``ctx`` form."""

    @staticmethod
    def forward(x, gain, eps, kernel):
        if kernel:
            return rn.rmsnorm(x, gain.float().contiguous(), eps)
        return ref.rmsnorm_ref(x, gain, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gain, eps, kernel = inputs
        ctx.save_for_backward(x, gain)
        ctx.eps, ctx.kernel = eps, kernel

    @staticmethod
    def vmap(info, in_dims, x, gain, eps, kernel):
        """N candidates in one call: x (N, ..., D) and a gain per candidate
        (N, D), one group of rows each; a shared gain stays (D,), and an
        unbatched x is broadcast to the N candidates."""
        xd, gd = in_dims[:2]
        x = x.movedim(xd, 0) if xd is not None else x.expand(info.batch_size, *x.shape)
        if gd is not None:
            gain = gain.movedim(gd, 0)
        if kernel:
            x = x.contiguous()
        return _rmsnorm_apply(x, gain, eps, kernel), 0


def _rmsnorm_apply(x, gain, eps, kernel):
    return (_RMSNormVmap if _transforms_active() else _RMSNorm).apply(x, gain, eps, kernel)


def fused_rmsnorm(x, gain, *, eps: float = 1e-6, impl: str = "auto"):
    """RMSNorm with the ``(1 + gain)`` convention, differentiable in x and
    gain.  Where no gradient is wanted (grad mode off, or neither x nor gain
    requires one) the forward runs alone, without the autograd Function's
    cost: the serve path's 61 calls a forward."""
    kernel = resolve_impl(impl, x) == "kernel"
    if kernel:
        x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or gain.requires_grad):
        return _RMSNorm.apply(x, gain, eps, kernel)
    if _transforms_active():
        # under vmap a batched tensor reports no gradient whatever its
        # physical tensor wants: the Function's vmap rule makes the call
        return _RMSNormVmap.apply(x, gain, eps, kernel)
    if kernel:
        return rn.rmsnorm(x, gain.float().contiguous(), eps)
    return ref.rmsnorm_ref(x, gain, eps)


class _SoftmaxXent(torch.autograd.Function):
    """B3 forward, B4 backward (or their plain versions) over (N, V) logits
    and (N,) clamped int32 labels: ``(loss, lse)``, lse not differentiable.
    The residuals are the logits, the labels and the (N,) lse; labels get
    no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, kernel):
        out = _SoftmaxXentVmap.forward(logits, labels, kernel)
        _SoftmaxXentVmap.setup_context(ctx, (logits, labels, kernel), out)
        return out

    @staticmethod
    def backward(ctx, g, _):
        logits, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.kernel:
            dlogits = ce.ce_bwd(logits, labels, lse, g)
        else:
            dlogits = ref.softmax_cross_entropy_bwd_ref(logits, labels, lse, g)
        return dlogits, None, None


class _SoftmaxXentVmap(_SoftmaxXent):
    """:class:`_SoftmaxXent` in the ``setup_context`` form, for
    ``torch.func`` transforms (as :class:`_RMSNormVmap`)."""

    @staticmethod
    def forward(logits, labels, kernel):
        if kernel:
            return ce.ce_fwd(logits, labels)
        return ref.softmax_cross_entropy_ref(logits, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, kernel = inputs
        lse = output[1]
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(logits, labels, lse)
        ctx.kernel = kernel

    @staticmethod
    def vmap(info, in_dims, logits, labels, kernel):
        """N candidates in one call: the candidate axis folds into the rows,
        (N, rows, V) -> (N * rows, V), and shared labels repeat N times."""
        ld, bd = in_dims[:2]
        n = info.batch_size
        logits = logits.movedim(ld, 0) if ld is not None else logits.expand(n, *logits.shape)
        rows, V = logits.shape[1:]
        labels = labels.movedim(bd, 0).reshape(-1) if bd is not None else labels.repeat(n)
        x2 = logits.reshape(n * rows, V)
        if kernel:
            x2 = x2.contiguous()
        loss, lse = _xent_apply(x2, labels.contiguous(), kernel)
        return (loss.reshape(n, rows), lse.reshape(n, rows)), (0, 0)


def _xent_apply(logits, labels, kernel):
    return (_SoftmaxXentVmap if _transforms_active() else _SoftmaxXent).apply(
        logits, labels, kernel)


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
    return _xent_apply(x2, lab2, kernel)[0].reshape(logits.shape[:-1])


class _FlashAttention(torch.autograd.Function):
    """The flash forward, then its backward from ``(q, k, v, o, lse)``: the
    backward recomputes p from lse, never saving an (S, T) matrix.  ``fwd``
    and ``bwd`` are B5 and B6 + B7 (:func:`_kernel_bwd`), or their plain
    versions at the same contract.  Returns ``(o, lse)``, lse not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, policy, fwd, bwd):
        inputs = (q, k, v, causal, window, softcap, policy, fwd, bwd)
        out = _FlashAttentionVmap.forward(*inputs)
        _FlashAttentionVmap.setup_context(ctx, inputs, out)
        return out

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # softmax-jacobian correction rowsum(do * o), laid out (B, H, S) like
        # lse, in plain torch between the kernels as the reference does it
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = ctx.bwd(q, k, v, do, lse, delta, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


class _FlashAttentionVmap(_FlashAttention):
    """:class:`_FlashAttention` in the ``setup_context`` form, for
    ``torch.func`` transforms (as :class:`_RMSNormVmap`)."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, policy, fwd, bwd):
        return fwd(q, k, v, causal=causal, window=window, softcap=softcap, policy=policy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, policy, fwd, bwd = inputs
        lse = output[1]
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, output[0], lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, policy=policy)
        ctx.bwd = bwd

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap, policy, fwd, bwd):
        """N candidates in one call: the candidate axis folds into the
        batch, q (N, B, S, H, d) -> (N * B, S, H, d), k and v alike (an
        unbatched one expanded to N first).  Exact in every operand mode:
        each (batch row, head) owns its tiles, and the int8 scales lie
        along S or T inside one.  The backward then runs once, outside the
        vmap, on the folded tensors."""
        n = info.batch_size
        t = [x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
             for x, d in zip((q, k, v), in_dims[:3])]
        if q.is_cuda:
            fa.check_candidates(n, t[0].shape[1:], t[1].shape[1:])
        q, k, v = (x.reshape(-1, *x.shape[2:]).contiguous() for x in t)
        o, lse = _flash_apply(q, k, v, causal, window, softcap, policy, fwd, bwd)
        return (o.reshape(n, -1, *o.shape[1:]), lse.reshape(n, -1, *lse.shape[1:])), (0, 0)


def _flash_apply(*args):
    return (_FlashAttentionVmap if _transforms_active() else _FlashAttention).apply(*args)


def _kernel_bwd(q, k, v, do, lse, delta, **kw):
    """(dq, dk, dv) from B6 and B7 (in the int8 mode after one pre-pass)."""
    return fa.flash_bwd(q, k, v, do, lse, delta, **kw)


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
    # a sweep's per-candidate scale (a batched 0-d tensor under vmap) is
    # folded here too, so it reaches the Function as part of q
    qs = (q.float() * scale).to(q.dtype).contiguous()
    return _flash_apply(qs, k.contiguous(), v.contiguous(), causal, window,
                        softcap, policy, fwd, bwd)[0]
