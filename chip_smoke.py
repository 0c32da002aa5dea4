#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), then runs these phases, each of which
raises on a failed check:

- kernels: each kernel against its plain PyTorch version on the card, with
  its time, the plain version's, a PyTorch library call's and the bound.
  B1 RMSNorm (24 shapes, f32 atol 2e-5, bf16 2e-2); B2 RMSNorm backward at
  the train shape x (8, 512, 1024) and ragged rows/widths, f32 and bf16
  (dx at atol 2e-4 / rtol 1e-3, bf16 2e-2; dgain at the f32 gradient tier
  and bit-identical when repeated); B3/B4 chunked cross entropy at logits
  (4096, 2048) (the train shape), (4096, 49152) (smollm's vocab) and
  ragged V, with masked rows and a cotangent of order 1 on the others (loss
  and lse at atol 2e-5, dlogits at atol 2e-4 / rtol 1e-3, bf16 2e-2,
  masked rows exactly zero); B8 paged flash decode
  (8 cases: engine shape, MHA/MQA, window, softcap, bf16).
- serve: smollm-135m at its published full width through the static engine
  (random weights from a seed, ``zero_init_query=False``), once through the
  kernels and once through the plain versions: the same greedy tokens and
  steps, the first decode steps' logits within atol = rtol = 1e-4, and exact
  launch counts (B1 per forward, B8 per decode step, no B2/B3/B4); then a
  bf16 serve.
- train: mup-gpt at full width (8 layers, d_model 1024, vocab 2048), f32,
  batch 8 x seq 512.  The first step's loss (1e-5 relative) and every
  gradient (atol 2e-4 / rtol 1e-3) with the kernels against the plain
  versions; then 10 steps of ``train_loop`` through the kernels and 10 from
  the same init and batches through the plain versions: finite losses that
  fall, step-0 losses within 1e-5 relative, and exact launch counts per step
  (17 B1, 17 B2, 1 B3, 1 B4, no B8).  Its ms per step runs from the start
  of the batch's generation to the loss read back, as the reference's
  train loop times it; the batch's own share is printed beside it.
- profile: torch.profiler over a short serve and over one train step: the
  device's busy share and the kernels that take it.

Launch counts are set to 0 just before each main path (serve, train) and
read just after; launches made to compare or time a kernel do not count.
It needs one card, imports nothing of JAX or of the reference package,
catches no failure (the exit code is non-zero on any) and prints, last, one
JSON line: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.

Bounds (``bound_ms``) use the H100 SXM data-sheet rates: 3.35 TB/s of
device memory and 67 TFLOP/s of float32 outside the tensor cores.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # docs/kernels.md tiers
GRAD_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (2e-2, 0.0)}  # (atol, rtol)
TRAIN_LOSS_RTOL = 1e-5
SERVE_LOGIT_TOL = 1e-4   # atol and rtol, as the CPU tests hold logits
TIE_GAP = 1e-5
N_TIMED = 200


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n=N_TIMED, warmup=10):
    """Mean milliseconds per call on the card's clock (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def rmsnorm_phase(ops, rn, F):
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for rows in (1, 8, 256, 8192):
        for D in (48, 576, 1024):
            for dt in (torch.float32, torch.bfloat16):
                x = (3 * torch.randn(rows, D, device="cuda")).to(dt)
                g = 0.5 * torch.randn(D, device="cuda")
                got = ops.fused_rmsnorm(x, g, impl="kernel")
                want = ops.fused_rmsnorm(x, g, impl="ref")
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                worst[dt] = max(worst[dt], err)
                if not err <= ATOL[dt]:
                    raise AssertionError(
                        f"rmsnorm rows={rows} D={D} {dt}: max err {err}")
    log(f"[kernels] rmsnorm: 24 cases agree; max err f32 {worst[torch.float32]:.3g}"
        f", bf16 {worst[torch.bfloat16]:.3g}")

    # timing at the main path's decode shape: 4 slots x 1 token x d_model 576
    x = torch.randn(4, 1, 576, device="cuda")
    g = 0.5 * torch.randn(576, device="cuda")
    err = (ops.fused_rmsnorm(x, g, impl="kernel")
           - ops.fused_rmsnorm(x, g, impl="ref")).abs().max().item()
    ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="kernel"))
    plain_ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="ref"))
    w = (1 + g).to(x.dtype)
    library_ms = cuda_ms(lambda: F.rms_norm(x, (576,), weight=w, eps=1e-6))
    nbytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())

    # the prefill shape of the same path: one 256-token prompt
    xp = torch.randn(1, 256, 576, device="cuda")
    pre_ms = cuda_ms(lambda: ops.fused_rmsnorm(xp, g, impl="kernel"))
    pre_plain = cuda_ms(lambda: ops.fused_rmsnorm(xp, g, impl="ref"))
    pre_lib = cuda_ms(lambda: F.rms_norm(xp, (576,), weight=w, eps=1e-6))
    pre_bound, _ = bound(2 * xp.numel() * 4 + 576 * 4, 4 * xp.numel())
    log(f"[kernels] rmsnorm x (1, 256, 576) f32: {pre_ms:.5f} ms, plain "
        f"{pre_plain:.5f} ms, F.rms_norm {pre_lib:.5f} ms, bound {pre_bound:.6f} ms")

    # the train step's shape: batch 8 x seq 512 x d_model 1024
    xt = torch.randn(8, 512, 1024, device="cuda")
    gt = 0.5 * torch.randn(1024, device="cuda")
    wt = 1 + gt
    train = dict(
        ms=cuda_ms(lambda: ops.fused_rmsnorm(xt, gt, impl="kernel")),
        plain_ms=cuda_ms(lambda: ops.fused_rmsnorm(xt, gt, impl="ref")),
        library_ms=cuda_ms(lambda: F.rms_norm(xt, (1024,), weight=wt, eps=1e-6)),
        bound_ms=bound(2 * xt.numel() * 4 + 1024 * 4, 4 * xt.numel())[0],
    )
    log(f"[kernels] rmsnorm x (8, 512, 1024) f32: {train['ms']:.5f} ms, plain "
        f"{train['plain_ms']:.5f} ms, F.rms_norm {train['library_ms']:.5f} ms, "
        f"bound {train['bound_ms']:.6f} ms")
    return dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:28",
        shape="x (4, 1, 576) float32 (decode step)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="torch.nn.functional.rms_norm(weight=1+g)",
        at_train_shape=train,
    )


def paged_case(B, K, G, d, P, C, lens, q_dtype, kv_dtype, seed):
    """A pool with slot b's first lens[b] tokens written through a permuted
    page table; stale random bytes elsewhere; lens 0 -> q_pos = -1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N = B * C + 3
    q = torch.randn(B, K * G, d, device="cuda", generator=gen).to(q_dtype)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    perm = torch.randperm(N, device="cuda", generator=gen)
    tab = perm[:B * C].reshape(B, C).to(torch.int32)
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, T in enumerate(lens):
        t = torch.arange(T, device="cuda")
        pos[tab[b, t // P].long(), t % P] = t.to(torch.int32)
    q_pos = torch.tensor([T - 1 for T in lens], dtype=torch.int32, device="cuda")
    return q, kp, vp, pos, tab, q_pos


def decode_phase(ops, da, F):
    S = 4        # the serve phase's slots
    cases = [
        # (label, B, K, G, d, P, C, lens, q_dtype, kv_dtype, window, softcap)
        ("engine shape", 8, 3, 3, 64, 16, 20, [320, 201, 64, 17, 256, 8, 140, 99],
         torch.float32, torch.float32, 0, 0.0),
        ("engine shape bf16", 8, 3, 3, 64, 16, 20, [320, 201, 64, 17, 256, 8, 140, 99],
         torch.bfloat16, torch.bfloat16, 0, 0.0),
        ("MHA, half page, inactive", 4, 9, 1, 64, 16, 20, [9, 0, 160, 300],
         torch.float32, torch.float32, 0, 0.0),
        ("MQA, half page, inactive", 4, 1, 9, 64, 16, 20, [0, 41, 320, 72],
         torch.float32, torch.float32, 0, 0.0),
        ("window", 4, 3, 3, 64, 16, 20, [300, 45, 0, 128],
         torch.float32, torch.float32, 100, 0.0),
        ("softcap", 4, 3, 3, 64, 16, 20, [300, 45, 0, 128],
         torch.float32, torch.float32, 0, 30.0),
        ("window + softcap bf16", 4, 3, 3, 64, 16, 20, [300, 45, 0, 128],
         torch.bfloat16, torch.bfloat16, 64, 20.0),
        ("f32 q over bf16 pools", 4, 3, 3, 64, 16, 20, [57, 320, 1, 0],
         torch.float32, torch.bfloat16, 0, 0.0),
    ]
    for i, (label, B, K, G, d, P, C, lens, qdt, kvdt, window, cap) in enumerate(cases):
        q, kp, vp, pos, tab, q_pos = paged_case(B, K, G, d, P, C, lens, qdt, kvdt, i)
        kw = dict(scale=0.125, window=window, softcap=cap)
        got = ops.decode_attention(q, kp, vp, pos, tab, q_pos, impl="kernel", **kw)
        want = ops.decode_attention(q, kp, vp, pos, tab, q_pos, impl="ref", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATOL[torch.bfloat16 if torch.bfloat16 in (qdt, kvdt) else torch.float32]
        inactive = q_pos < 0
        if not err <= tol or torch.count_nonzero(got[inactive]) != 0:
            raise AssertionError(f"flash_decode case {label!r}: max err {err}")
        log(f"[kernels] flash_decode {label}: max err {err:.3g} (atol {tol})")

    # timing at the main path's decode shape: 4 slots, smollm-135m heads,
    # 20 pages of 16 per slot, slots part-way through their requests
    lens = [120, 200, 260, 310]
    q, kp, vp, pos, tab, q_pos = paged_case(S, 3, 3, 64, 16, 20, lens,
                                            torch.float32, torch.float32, 99)
    args = (q, kp, vp, pos, tab, q_pos)
    err = (ops.decode_attention(*args, scale=0.125, impl="kernel")
           - ops.decode_attention(*args, scale=0.125, impl="ref")).abs().max().item()
    ms = cuda_ms(lambda: ops.decode_attention(*args, scale=0.125, impl="kernel"))
    plain_ms = cuda_ms(lambda: ops.decode_attention(*args, scale=0.125, impl="ref"))
    # yardstick: SDPA over pre-gathered contiguous K/V of the same live
    # lengths (attention only: the gather is not timed)
    T = max(lens)
    kk = torch.zeros(S, 3, T, 64, device="cuda")
    vv = torch.zeros(S, 3, T, 64, device="cuda")
    mask = torch.zeros(S, 1, 1, T, dtype=torch.bool, device="cuda")
    for b, L in enumerate(lens):
        t = torch.arange(L, device="cuda")
        page = tab[b, t // 16].long()
        kk[b, :, :L] = kp[page, t % 16].permute(1, 0, 2)
        vv[b, :, :L] = vp[page, t % 16].permute(1, 0, 2)
        mask[b, ..., :L] = True
    qq = q[:, :, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=0.125, enable_gqa=True))
    B, H, d = q.shape
    live_pages = sum(min(20, (L - 1) // 16 + 1) for L in lens)
    nbytes = (2 * live_pages * 16 * 3 * 64 * 4      # live K and V
              + live_pages * 16 * 4 + live_pages * 4  # positions, table entries
              + 2 * q.numel() * 4 + S * 4)            # q, out, q_pos
    flops = 4 * H * d * live_pages * 16
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:44",
        shape="q (4, 9, 64) f32, pools (80, 16, 3, 64) f32, live lens "
              + ",".join(map(str, lens)),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="torch.nn.functional.scaled_dot_product_attention over "
                "pre-gathered K/V (attention only)",
    )



def check_close(what, got, want, atol, rtol=0.0):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return the
    max abs error."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    err = diff.max().item()
    if not excess <= 0:
        raise AssertionError(f"{what}: max abs err {err} (atol {atol}, rtol {rtol})")
    return err


def rmsnorm_bwd_phase(rn, ref, F):
    """B2 against its plain version; timed at the train shape."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [(8, 512, 1024)] + [(r, D) for r in (1, 7, 4097) for D in (48, 1024)]
    for shape in shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn(*shape, device="cuda")).to(dt)
            g = 0.5 * torch.randn(shape[-1], device="cuda")
            dy = torch.randn(*shape, device="cuda").to(dt)
            dx, dg = rn.rmsnorm_bwd(x, g, dy)
            want_dx, want_dg = ref.rmsnorm_bwd_ref(x, g, dy)
            torch.cuda.synchronize()
            what = f"rmsnorm_bwd {shape} {dt}"
            err = check_close(what + " dx", dx, want_dx, *GRAD_TOL[dt])
            check_close(what + " dgain", dg, want_dg, *GRAD_TOL[torch.float32])
            if not torch.equal(rn.rmsnorm_bwd(x, g, dy)[1], dg):
                raise AssertionError(f"{what}: dgain differs between two calls")
            worst[dt] = max(worst[dt], err)
    log(f"[kernels] rmsnorm_bwd: {2 * len(shapes)} cases agree, dgain "
        f"deterministic; max dx err f32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g}")

    x = torch.randn(8, 512, 1024, device="cuda")
    g = 0.5 * torch.randn(1024, device="cuda")
    dy = torch.randn_like(x)
    dx, _ = rn.rmsnorm_bwd(x, g, dy)
    err = (dx - ref.rmsnorm_bwd_ref(x, g, dy)[0]).abs().max().item()
    ms = cuda_ms(lambda: rn.rmsnorm_bwd(x, g, dy))
    plain_ms = cuda_ms(lambda: ref.rmsnorm_bwd_ref(x, g, dy))
    xl = x.clone().requires_grad_(True)
    wl = (1 + g).requires_grad_(True)
    yl = F.rms_norm(xl, (1024,), weight=wl, eps=1e-6)
    library_ms = cuda_ms(lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                     retain_graph=True))
    nbytes = 3 * x.numel() * 4 + 2 * 1024 * 4
    bound_ms, bound_by = bound(nbytes, 12 * x.numel())
    return dict(
        name="rmsnorm_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:36",
        shape="x, dy (8, 512, 1024) float32 (train step)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="autograd backward of torch.nn.functional.rms_norm",
    )


def ce_case(N, V, dt, seed):
    """Logits with a wide range, labels with every third row from the second
    masked (-100) and the loss cotangent zero on those rows, as
    Model.loss_fn makes it.  On the other rows g ~ U(0.5, 1.5), not the
    loss's 1/n_rows, so dlogits stay of the order of the softmax itself and
    the check at GRAD_TOL sees an error in either of its terms."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (4 * torch.randn(N, V, device="cuda", generator=gen)).to(dt)
    labels = torch.randint(0, V, (N,), device="cuda", generator=gen,
                           dtype=torch.int32)
    labels[1::3] = -100
    mask = labels >= 0
    g = (0.5 + torch.rand(N, device="cuda", generator=gen)) * mask
    return x, labels.clamp(0, V - 1), g.float(), mask


def ce_phase(ce, ref, F):
    """B3 and B4 against their plain versions; timed at the train shape
    (4096 rows x vocab 2048) and at smollm's vocab (49152)."""
    cases = [(4096, 2048, torch.float32), (4096, 49152, torch.float32),
             (1, 7, torch.float32), (37, 1000, torch.float32),
             (64, 50257, torch.float32), (256, 2048, torch.bfloat16),
             (33, 3001, torch.bfloat16)]
    worst = [0.0, 0.0]
    for i, (N, V, dt) in enumerate(cases):
        x, lab, g, mask = ce_case(N, V, dt, i)
        loss, lse = ce.ce_fwd(x, lab)
        dx = ce.ce_bwd(x, lab, lse, g)
        want_loss, want_lse = ref.softmax_cross_entropy_ref(x, lab)
        want_dx = ref.softmax_cross_entropy_bwd_ref(x, lab, want_lse, g)
        torch.cuda.synchronize()
        what = f"cross entropy ({N}, {V}) {dt}"
        atol = ATOL[dt]
        worst[0] = max(worst[0], check_close(what + " loss", loss, want_loss, atol))
        check_close(what + " lse", lse, want_lse, atol)
        worst[1] = max(worst[1], check_close(what + " dlogits", dx, want_dx,
                                             *GRAD_TOL[dt]))
        if torch.count_nonzero(dx[~mask]) != 0:
            raise AssertionError(f"{what}: masked rows have non-zero dlogits")
    log(f"[kernels] ce_fwd/ce_bwd: {len(cases)} cases agree, masked rows zero; "
        f"max loss err {worst[0]:.3g}, max dlogits err {worst[1]:.3g}")

    rows = {}
    for N, V in ((4096, 2048), (4096, 49152)):
        x, lab, g, _ = ce_case(N, V, torch.float32, 100 + V)
        loss, lse = ce.ce_fwd(x, lab)
        want_loss, want_lse = ref.softmax_cross_entropy_ref(x, lab)
        fwd_err = (loss - want_loss).abs().max().item()
        bwd_err = (ce.ce_bwd(x, lab, lse, g)
                   - ref.softmax_cross_entropy_bwd_ref(x, lab, lse, g)).abs().max().item()
        t = {
            "ce_fwd": cuda_ms(lambda: ce.ce_fwd(x, lab)),
            "ce_fwd_plain": cuda_ms(lambda: ref.softmax_cross_entropy_ref(x, lab)),
            "ce_bwd": cuda_ms(lambda: ce.ce_bwd(x, lab, lse, g)),
            "ce_bwd_plain": cuda_ms(
                lambda: ref.softmax_cross_entropy_bwd_ref(x, lab, lse, g)),
        }
        lab64 = lab.long()
        t["ce_fwd_library"] = cuda_ms(
            lambda: F.cross_entropy(x, lab64, reduction="none"))
        xl = x.clone().requires_grad_(True)
        yl = F.cross_entropy(xl, lab64, reduction="none")
        t["ce_bwd_library"] = cuda_ms(
            lambda: torch.autograd.grad(yl, xl, g, retain_graph=True))
        del xl, yl
        b3 = bound(N * V * 4 + N * 4 + 2 * N * 4, 5 * N * V)
        b4 = bound(2 * N * V * 4 + 3 * N * 4, 4 * N * V)
        log(f"[kernels] cross entropy ({N}, {V}) f32: ce_fwd {t['ce_fwd']:.4f} ms "
            f"(plain {t['ce_fwd_plain']:.4f}, F.cross_entropy {t['ce_fwd_library']:.4f},"
            f" bound {b3[0]:.4f}); ce_bwd {t['ce_bwd']:.4f} ms (plain "
            f"{t['ce_bwd_plain']:.4f}, its autograd backward {t['ce_bwd_library']:.4f},"
            f" bound {b4[0]:.4f})")
        rows[V] = (t, b3, b4, fwd_err, bwd_err)
        del x, g, lse, loss, want_loss, want_lse
        torch.cuda.empty_cache()

    t, b3, b4, fwd_err, bwd_err = rows[2048]
    big = dict(rows[49152][0], ce_fwd_bound=rows[49152][1][0],
               ce_bwd_bound=rows[49152][2][0])
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/cross_entropy.cu",
                  shape="logits (4096, 2048) float32 (train step), 1/3 rows masked")
    return [
        dict(name="ce_fwd", replaces="src/repro/kernels/cross_entropy.py:38",
             max_abs_err=fwd_err, ms=t["ce_fwd"], plain_ms=t["ce_fwd_plain"],
             bound_ms=b3[0], bound_by=b3[1], library_ms=t["ce_fwd_library"],
             library="torch.nn.functional.cross_entropy(reduction='none')",
             at_vocab_49152={k: big[k] for k in ("ce_fwd", "ce_fwd_plain",
                                                 "ce_fwd_library", "ce_fwd_bound")},
             **common),
        dict(name="ce_bwd", replaces="src/repro/kernels/cross_entropy.py:74",
             max_abs_err=bwd_err, ms=t["ce_bwd"], plain_ms=t["ce_bwd_plain"],
             bound_ms=b4[0], bound_by=b4[1], library_ms=t["ce_bwd_library"],
             library="autograd backward of torch.nn.functional.cross_entropy",
             at_vocab_49152={k: big[k] for k in ("ce_bwd", "ce_bwd_plain",
                                                 "ce_bwd_library", "ce_bwd_bound")},
             **common),
    ]

# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def make_recording_model(Model):
    class RecordingModel(Model):
        """Keeps, for every forward the engine runs, the top-2 logits of the
        rows it samples from, and the full rows of the first 8 decodes."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            self.n_decode = 0

        def forward(self, params, tokens, positions=None, mode="train", **kw):
            logits, cache = super().forward(params, tokens, positions=positions,
                                            mode=mode, **kw)
            if mode == "prefill":
                plen = int((positions[0] < positions.shape[1]).sum())
                rows = logits[:, plen - 1]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            else:
                rows = logits[:, 0]
                active = positions[:, 0] >= 0
            top2 = rows.float().topk(2, dim=-1)
            keep = mode == "decode" and self.n_decode < 8
            self.n_decode += mode == "decode"
            self.calls.append(dict(mode=mode, top2=top2.values, arg=top2.indices[:, 0],
                                   active=active, rows=rows.clone() if keep else None))
            return logits, cache

    return RecordingModel


def serve_phase(cfg_f32, Model, Engine, EngineConfig, ops):
    R, S, Pmax, Gmax, P = 8, 4, 256, 64, 16
    rng = np.random.default_rng(0)
    lens = rng.integers(64, Pmax + 1, R)
    prompts = rng.integers(0, cfg_f32.vocab_size, (R, Pmax))
    ecfg = EngineConfig(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    Rec = make_recording_model(Model)

    kern = Rec(cfg_f32, device="cuda", impl="auto")
    plain = Rec(cfg_f32, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    log(f"[serve] {cfg_f32.name}: {cfg_f32.n_layers} layers, d_model {cfg_f32.d_model}, "
        f"{cfg_f32.n_heads}/{cfg_f32.n_kv_heads} heads, vocab {cfg_f32.vocab_size}, "
        f"{n_params / 1e6:.1f}M params; {R} requests, prompt lens {lens.tolist()}, "
        f"{Gmax} tokens each, {S} slots, page {P}")

    # warm-up (cuBLAS handles, allocator) outside the counted run
    Engine(kern, EngineConfig(n_slots=2, page_size=P, max_prompt_len=Pmax,
                              max_gen_len=2)).serve(params, prompts[:1], lens[:1])
    kern.calls.clear()
    kern.n_decode = 0

    engine = Engine(kern, ecfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = out_k["steps"]
    # one decode attention per layer per step; two norms per layer plus the
    # final norm per forward (a decode step or an admission's prefill); no
    # backward and no loss
    L = cfg_f32.n_layers
    want = {"flash_decode": L * steps, "rmsnorm": (2 * L + 1) * (steps + R),
            "rmsnorm_bwd": 0, "ce_fwd": 0, "ce_bwd": 0}
    log(f"[serve] kernels: {steps} steps, launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    t0 = time.perf_counter()
    out_r = Engine(plain, ecfg).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    n_tok = int(out_k["lengths"].sum())
    log(f"[serve] kernels: {n_tok} tokens in {wall_k:.3f} s ({n_tok / wall_k:.1f} tok/s); "
        f"plain: {int(out_r['lengths'].sum())} tokens in {wall_r:.3f} s "
        f"({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s)")

    if out_k["steps"] != out_r["steps"] or len(kern.calls) != len(plain.calls):
        raise AssertionError(f"steps differ: {out_k['steps']} vs {out_r['steps']}")
    tie_at = None
    for i, (ck, cr) in enumerate(zip(kern.calls, plain.calls)):
        differ = (ck["arg"] != cr["arg"]) & cr["active"]
        if bool(differ.any()):
            j = int(differ.nonzero()[0, 0])
            gap = float(cr["top2"][j, 0] - cr["top2"][j, 1])
            if gap >= TIE_GAP:
                raise AssertionError(
                    f"greedy token differs at forward {i} ({cr['mode']}) row {j}, "
                    f"plain top-2 gap {gap}")
            log(f"[serve] tie: forward {i} ({cr['mode']}) row {j}, plain top-2 gap "
                f"{gap:.3g} < {TIE_GAP}; later tokens of that request may differ")
            tie_at = i
            break
    if tie_at is None and not torch.equal(out_k["tokens"], out_r["tokens"]):
        raise AssertionError("greedy tokens differ with and without the kernels")
    worst = excess = scale = 0.0
    for ck, cr in zip(kern.calls[:tie_at], plain.calls[:tie_at]):
        if ck["rows"] is not None:
            diff = (ck["rows"] - cr["rows"]).abs()
            worst = max(worst, diff.max().item())
            scale = max(scale, cr["rows"].abs().max().item())
            # allclose: |a - b| <= atol + rtol * |b|
            excess = max(excess, (diff - SERVE_LOGIT_TOL * (1 + cr["rows"].abs()))
                         .max().item())
    if not excess <= 0:
        raise AssertionError(f"decode logits differ by {worst} (|logit| <= {scale})")
    log(f"[serve] greedy tokens identical: {tie_at is None}; steps identical; "
        f"first 8 decode steps' logits max abs diff {worst:.3g} at |logit| <= "
        f"{scale:.3g} (atol = rtol = {SERVE_LOGIT_TOL})")

    # bfloat16 activations and pools, the same float32 master weights
    bf = Rec(cfg_f32.replace(dtype="bfloat16"), device="cuda", impl="auto")
    t0 = time.perf_counter()
    out_b = Engine(bf, ecfg).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    if not all(bool(torch.isfinite(c["top2"]).all()) for c in bf.calls):
        raise AssertionError("bf16 serve produced non-finite logits")
    agree = float((out_b["tokens"] == out_k["tokens"]).float().mean())
    log(f"[serve] bf16: {int(out_b['lengths'].sum())} tokens in {wall_b:.3f} s, "
        f"finite logits, {agree:.1%} of tokens equal to the f32 run")
    return launches, dict(steps=steps, tokens=n_tok, wall_s=wall_k,
                          plain_wall_s=wall_r, bf16_wall_s=wall_b,
                          bf16_token_agreement=agree)


# the port's kernels, by the name of their __global__ function(s)
PORT_KERNELS = {
    "rmsnorm": ("rmsnorm_kernel<",),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernel<", "column_sum_kernel("),
    "ce_fwd": ("ce_fwd_kernel<",),
    "ce_bwd": ("ce_bwd_kernel<",),
    "flash_decode": ("flash_decode_kernel<",),
}


def port_kernel_times(kernels):
    """{kernel: (device ms in total, launches)} of the port's kernels among
    the profiler's CUDA events."""
    out = {}
    for name, keys in PORT_KERNELS.items():
        parts = {k: [e for e in kernels if k in e.key] for k in keys}
        hits = [e for es in parts.values() for e in es]
        if not hits:
            continue
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        n = sum(e.count for e in hits)
        out[name] = (ms, n)
        split = "" if len(keys) == 1 else " = " + " + ".join(
            f"{k.rstrip('<(')} {sum(e.self_device_time_total for e in es) / 1e3:.3f} ms"
            for k, es in parts.items())
        log(f"[profile]   port kernel {name}: {ms:.3f} ms in {n} launches "
            f"({ms / n * 1e3:.2f} us each){split}")
    return out



def profile_phase(cfg, Model, Engine, EngineConfig):
    """Where a decode-heavy serve spends the card's time: torch.profiler over
    a short serve (4 requests x 16 tokens), device busy share and the
    kernels that take it.  The profiler's own overhead inflates the wall."""
    from torch.profiler import ProfilerActivity, profile

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))
    lens = np.full(4, 128)
    engine = Engine(model, EngineConfig(n_slots=4, page_size=16, max_prompt_len=128,
                                        max_gen_len=16))
    engine.serve(params, prompts, lens)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = engine.serve(params, prompts, lens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] {out['steps']} steps in {wall_us / 1e3:.1f} ms under the profiler; "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    return dict(steps=out["steps"], wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                launches=sum(e.count for e in kernels),
                port_kernels=port_kernel_times(kernels))



# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def train_phase(ops):
    """mup-gpt at full width: the first step's gradients with and without
    the kernels, then 10 train_loop steps each way from the same init and
    batches; launch counts of the kernel run."""
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import HParams, transfer
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import Model
    from repro_torch.optim.grad import value_and_grad

    B, S, STEPS = 8, 512, 10
    cfg = get_config("mup-gpt").replace(dtype="float32")
    hps = HParams()
    model_cfg = cfg.replace(**transfer(hps, cfg)["model"])
    kern = Model(model_cfg, device="cuda", impl="auto")
    plain = Model(model_cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    batch0 = {k: torch.from_numpy(v).cuda() for k, v in
              make_pipeline(cfg.vocab_size, S, B, seed=0).batch(0).items()}
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f}M params; batch {B} x seq {S}, f32")

    loss_k, grads_k = value_and_grad(kern.loss_fn, params, batch0)
    loss_p, grads_p = value_and_grad(plain.loss_fn, params, batch0)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"first-step loss {float(loss_k)} vs plain "
                             f"{float(loss_p)} (rel {rel})")
    grad_err = {n: check_close(f"first-step grad {n}", grads_k[n], grads_p[n],
                               *GRAD_TOL[torch.float32]) for n in grads_p}
    log(f"[train] first step: loss {float(loss_k):.6f} vs plain {float(loss_p):.6f} "
        f"(rel {rel:.3g}); gradients agree, max abs err per tensor "
        + ", ".join(f"{n} {e:.2g}" for n, e in grad_err.items()))
    del grads_k, grads_p

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out_k = train_loop(cfg, STEPS, hps, batch_size=B, seq_len=S, seed=0,
                         log_every=1, device="cuda", impl="auto")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_step = {"rmsnorm": 2 * cfg.n_layers + 1, "rmsnorm_bwd": 2 * cfg.n_layers + 1,
                "ce_fwd": 1, "ce_bwd": 1, "flash_decode": 0}
    want = {k: v * STEPS for k, v in per_step.items()}
    log(f"[train] kernels: launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")

    ops.reset_launch_counts()
    out_p = train_loop(cfg, STEPS, hps, batch_size=B, seq_len=S, seed=0,
                         log_every=0, device="cuda", impl="ref")
    torch.cuda.synchronize()
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"plain run launched kernels: {ops.launch_counts()}")

    lk, lp = out_k["losses"], out_p["losses"]
    if not all(np.isfinite(lk + lp)):
        raise AssertionError(f"non-finite losses: {lk} / {lp}")
    if not (lk[-1] < lk[0] and lp[-1] < lp[0]):
        raise AssertionError(f"loss did not fall: {lk} / {lp}")
    rel0 = abs(lk[0] - lp[0]) / abs(lp[0])
    if not rel0 <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"step-0 loss {lk[0]} vs plain {lp[0]}")
    rel_all = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    # steady state: the first step builds cuBLAS handles and the allocator
    ms_k = 1e3 * float(np.median(out_k["step_seconds"][1:]))
    ms_p = 1e3 * float(np.median(out_p["step_seconds"][1:]))
    # the part of a step spent making the batch on the host and copying it
    batch_k = 1e3 * float(np.median(out_k["batch_seconds"][1:]))
    batch_p = 1e3 * float(np.median(out_p["batch_seconds"][1:]))
    log(f"[train] losses with kernels {[round(v, 4) for v in lk]}")
    log(f"[train] losses plain        {[round(v, 4) for v in lp]}")
    log(f"[train] step-0 loss rel diff {rel0:.3g}, max over steps {rel_all:.3g}; "
        f"ms/step (median of steps 1-{STEPS - 1}, batch generation included) "
        f"kernels {ms_k:.2f} ({B * S / ms_k * 1e3:.0f} tok/s, of which batch "
        f"{batch_k:.2f} ms), plain {ms_p:.2f} ({B * S / ms_p * 1e3:.0f} tok/s, "
        f"batch {batch_p:.2f} ms); peak memory {peak_gib:.2f} GiB")
    return launches, dict(
        steps=STEPS, batch=B, seq=S, tokens_per_step=B * S,
        losses=lk, plain_losses=lp, step0_rel_diff=rel0, max_rel_diff=rel_all,
        ms_per_step=ms_k, plain_ms_per_step=ms_p,
        batch_ms=batch_k, plain_batch_ms=batch_p,
        tok_per_s=B * S / ms_k * 1e3, plain_tok_per_s=B * S / ms_p * 1e3,
        step_seconds=out_k["step_seconds"], plain_step_seconds=out_p["step_seconds"],
        batch_seconds=out_k["batch_seconds"],
        peak_memory_gib=peak_gib,
    )


def train_profile_phase():
    """torch.profiler over one steady train step (after a warm-up step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.optim.schedules import linear_decay

    cfg = get_config("mup-gpt").replace(dtype="float32")
    model = Model(cfg, device="cuda")
    opt = Optimizer.create("adamw", 1e-2, model.p13n, model.meta,
                           schedule=linear_decay(10))
    step = make_train_step(model, opt)
    params = model.init(seed=0)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             make_pipeline(cfg.vocab_size, 512, 8, seed=0).batch(0).items()}
    params, state, _ = step(params, state, batch)     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        float(metrics["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] one train step: {wall_us / 1e3:.1f} ms under the profiler; "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                launches=sum(e.count for e in kernels),
                port_kernels=port_kernel_times(kernels),
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top])

# ---------------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc: {build.build_seconds if build.build_seconds is not None else 'cached'})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    torch.manual_seed(0)
    rows = [rmsnorm_phase(ops, rn, F), rmsnorm_bwd_phase(rn, ref, F),
            *ce_phase(ce, ref, F), decode_phase(ops, da, F)]
    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False)
    serve_launches, serve = serve_phase(cfg, Model, Engine, EngineConfig, ops)
    train_launches, train = train_phase(ops)
    serve["profile"] = profile_phase(cfg, Model, Engine, EngineConfig)
    train["profile"] = train_profile_phase()
    for row in rows:
        by_path = {"serve": serve_launches[row["name"]],
                   "train": train_launches[row["name"]]}
        if not sum(by_path.values()):
            raise AssertionError(f"{row['name']} was launched on no main path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        log(json.dumps(row))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"train": train}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
