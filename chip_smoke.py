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
  masked rows exactly zero); B5/B6/B7 flash attention forward, dq and dk/dv
  in the f32, bf16 and int8 operand modes at the train shape (8, 512, 16
  heads of 64, causal), smollm's 9/3 heads (GQA), a window of 48, softcap
  20 (logits up to ~20), ragged S (200, 190), bf16 storage and d_head 128,
  with a cotangent of order 1: each kernel against its plain version at
  its own contract (kernels/ref.py flash_fwd_ref, flash_bwd_ref, which
  round or quantize where the kernels do, over the same tiles) on the same
  inputs, lse at atol 2e-5 / rtol 1e-5, o and dq/dk/dv at the f32 tiers
  where nothing rounds to bf16, else max abs err within the bf16 tiers (the
  int8 tier, 5e-2, in the int8 mode) and mean within 3e-5, which the
  f32-mode outputs must fail against the bf16 plain versions and the int8
  outputs against the int8 plain versions tiled 64 wide; dk/dv
  bit-identical when repeated; then ops.attention's autograd Function in
  the f32 mode against the plain attention under autograd (the f32 tiers);
  each mode timed at the train shape, the int8 kernels with their device
  time per launch; B8 paged flash decode
  (8 cases: engine shape, MHA/MQA, window, softcap, bf16); B9 paged
  multi-query flash decode (12 cases: the engine's chunk of 64 with the
  history partly resident, its last chunk with rows past the prompt at -1,
  T not a multiple of the row tile, the speculative-verify shape B = 4,
  T = 5, MHA/MQA, window, softcap, bf16 and f32-over-bf16 pools, two slots
  whose tables map the same pages; f32 atol 2e-5, bf16 2e-2, rows at -1
  exactly zero) and at T = 1 against B8 on the same inputs; the int8-pool
  modes of B8 (8 cases at the engine's decode shape q (4, 9, 64) over
  (83, 16, 3, 64) int8 pools with (83, 3) scales: an inactive slot,
  MHA/MQA, window, softcap, bf16 q) and of B9 (8 cases: the engine's chunk
  of 64 with history resident, its last chunk with rows at -1, the verify
  shape B = 4, T = 5, MHA/MQA, window + softcap, bf16 q, two slots sharing
  pages; and T = 1 against B8's int8 mode), each against its plain version
  at atol 2e-5 (bf16 q 2e-2), rows at -1 exactly zero, timed beside SDPA
  over the gathered dequantized K/V.
- serve: smollm-135m at its published full width through the static engine
  (random weights from a seed, ``zero_init_query=False``), once through the
  kernels and once through the plain versions: the same greedy tokens and
  steps, the first decode steps' logits within atol = rtol = 1e-4, and exact
  launch counts (B1 per forward, B8 per decode step, no B2/B3/B4); then a
  bf16 serve.
- serve_dynamic: the same model through DynamicEngine (the serve CLI's
  default): 4 slots, page 16, prompts up to 256, 64 tokens each,
  prefill_chunk 64, prefix cache on, 16 requests made of 4 shared system
  prompts of 96-160 tokens and unique suffixes of 16-96, all present at
  t = 0.  (a) tokens and steps equal with the kernels and through the
  plain versions (the serve phase's rule for near-ties); (b) greedy tokens
  equal to the static engine's and (c) to the dynamic engine's without the
  prefix cache, which shares nothing where this one shares (a request past
  a near-tie, where a plain full-sequence forward's top-2 gap is below
  TIE_GAP, may differ after it); (d) a second serve on the same engine
  shares more prompt tokens (a warm cache); (e) exact launch counts: B9 30
  per chunk forward, B8 30 per decode step, B1 61 per forward, no B2-B7,
  with the chunk forwards counted from the model's calls and held against
  the chunk schedule recomputed from prefill_cached.
- serve_int8: the same model with int8 paged KV pools (``--kv-dtype
  int8``) through DynamicEngine on serve_dynamic's workload and through
  the static engine on 8 of its requests: (a) tokens and steps equal with
  the kernels and through the plain versions on both engines; (b) the
  dynamic engine's tokens equal with the prefix cache off and (c) on a
  warm cache that shares more; (d) exact launch counts: B8 int8 30 per
  decode step, B9 int8 30 per chunk forward, B1 61 per forward, no f32/bf16
  B8/B9, no B2-B7.  Prints tok/s, the pools' MiB against f32 pools and the
  greedy top-1 agreement with the f32 dynamic engine (not held).  Nothing
  is cut: the int8 static serve runs 8 requests where the dynamic one runs
  16, to keep the run short.
- train: mup-gpt at full width (8 layers, d_model 1024, vocab 2048), f32,
  batch 8 x seq 512.  The first step's loss (1e-5 relative) and every
  gradient (atol 2e-4 / rtol 1e-3) with the kernels against the plain
  versions, from weights with a random query projection (so attention is
  not uniform); then 10 steps of ``train_loop`` through the kernels and 10 from
  the same init and batches through the plain versions: finite losses that
  fall, step-0 losses within 1e-5 relative, and exact launch counts per step
  (17 B1, 17 B2, 1 B3, 1 B4, no B5-B8).  Its ms per step runs from the
  start of the batch's generation to the loss read back, as the
  reference's train loop times it; the batch's own share and the peak
  memory of both runs are printed beside it.
- train --amp bf16: the same at the same width, with the mixed-precision
  policy: attention through B5-B7 in the bf16 operand mode, the readout
  logit matmul in bf16 operands.  The plain side's attention rounds where
  the kernels do (ops.attention_plain_flash).  The first step's loss and
  step 0 of the loop within limits that a control in the f32 operand mode
  must fail, every first-step gradient within 3e-3 of its tensor's
  largest entry (AMP_* below); a third loop through the policy's own plain
  attention gives the plain time and memory; exact launch counts per step
  (8 B5, 8 B6, 8 B7, 17 B1, 17 B2, 1 B3, 1 B4, no B8).
- train --amp int8: the same with attention through B5-B7 in the int8
  operand mode and the readout's int8 straight-through matmul; the plain
  side's attention quantizes where the kernels do, tile by tile.  The first
  step with the kernels equals it (INT8_* below), where two controls, the
  bf16-mode kernels and the int8 plain versions tiled 64 wide, must fail
  the loss limit; step 0 of the loop within a limit the f32 run fails;
  exact launch counts per step (8 each of B5, B6 and B7 in the int8 mode,
  none in the others, 17 B1, 17 B2, 1 B3, 1 B4); the mean of the last 3
  losses against the f32 run's is printed (the reference's bar is 1%; not
  held on the card).
- profile: torch.profiler over a short serve through each engine, a short
  int8 dynamic serve (with the card's time in the quantized writes of
  serving/kv_cache.py) and one train step, f32, --amp bf16 and --amp int8:
  the device's busy share and the kernels that take it.

Launch counts are set to 0 just before each main path (serve,
serve_dynamic, serve_int8 dynamic and static, train, train --amp bf16,
train --amp int8) and
read just after; launches made to compare or time a kernel do not count.
It needs one card, imports nothing of JAX or of the reference package,
catches no failure (the exit code is non-zero on any) and prints, last, one
JSON line: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.

Bounds (``bound_ms``) use the H100 SXM data-sheet rates: 3.35 TB/s of
device memory, 67 TFLOP/s of float32 outside the tensor cores, 989 TFLOP/s
of dense bf16 on the tensor cores for B5-B7's bf16 operand mode and 1,979
TOP/s of dense int8 for their int8 mode.
"""
from __future__ import annotations

import contextlib
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
BF16_TC_FLOP_PER_S = 989e12
INT8_TC_OP_PER_S = 1979e12
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # docs/kernels.md tiers
GRAD_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (2e-2, 0.0)}  # (atol, rtol)
# B5-B7 against their plain versions at the kernels' contract
# (kernels/ref.py: flash_fwd_ref, flash_bwd_ref) where bf16 rounding enters
# (bf16 operands, or o stored in bf16).  The two sum in different orders, so
# an operand a few f32 ulps from its twin can round to the neighbouring bf16
# value: a few entries then differ by 2^-8 of one product (up to 0.019, dq
# of the softcap case, on an H100 at 700 W); the bf16 tiers bound the max.
# A rounding left out or put in the wrong place moves every entry instead:
# the mean error (at most 3.7e-6 there; the f32-mode outputs' at least
# 1.7e-4) is held at FLASH_MEAN_TOL.
FLASH_MAX_TOL = {"o": 2e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
FLASH_MEAN_TOL = 3e-5
# The int8 mode, against plain versions that quantize where the kernels do:
# an ulp of exp or tanh between the two could move a quantized p or ds
# across a half step, and a few entries would then differ by one step of
# their tile's scale (on an H100 at 700 W none does: every output equal);
# their max is held at the int8 tier against f32 (docs/kernels.md), the
# mean at FLASH_MEAN_TOL, which plain versions tiled 64 wide (the scales
# over other tiles; mean 9.0e-4 and more) must fail.
INT8_MAX_TOL = {"o": 5e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
FLASH_MODES = ("none", "bf16", "int8")
TRAIN_LOSS_RTOL = 1e-5
# --amp bf16, kernels against the plain side whose attention rounds where
# they do (an H100 at 700 W, B5 at 128-key tiles): the first step's loss
# 4.65e-7 relative apart, 1.64e-5 with attention's kernels in the f32
# operand mode (the control); step 0 of the loop 5.5e-7, 1.67e-5 for the
# f32 run.  The gradients cannot tell the modes apart: a few bf16 operands
# that round to the other neighbour after an f32 ulp of difference upstream
# move them by up to 1.1e-3 of a tensor's largest entry (wq), the f32 mode
# by 1.2e-4-1.7e-3; their limit bounds that noise.
AMP_LOSS_RTOL = 5e-6
AMP_GRAD_TOL = 3e-3        # times the tensor's largest plain gradient entry
AMP_LOOP_LOSS_RTOL = 3e-6
# --amp int8, the same checks: the plain side's attention quantizes where the
# kernels do, tile by tile.  The two give the same bits for the same inputs
# (B5's l summed in the kernel's order), so the first step is equal (an
# H100 at 700 W: loss and gradients 0 apart), where the bf16-mode control
# is 4.7e-6 / 7.8e-3 of a tensor's largest entry apart and the plain
# versions tiled 64 wide 4.2e-6 / 6.3e-3.  Step 0 of the loop runs B1-B4's
# plain versions on the plain side, whose ulps move int8 bytes: 4.4e-6,
# against 1.9e-5 for the f32 run.
INT8_LOSS_RTOL = 1e-6
INT8_GRAD_TOL = 1e-3
INT8_LOOP_LOSS_RTOL = 1e-5
# (first-step loss, first-step gradients, step 0 of the loop) by --amp, and the
# operand mode of the first step's control
AMP_LIMITS = {"bf16": (AMP_LOSS_RTOL, AMP_GRAD_TOL, AMP_LOOP_LOSS_RTOL, "none"),
              "int8": (INT8_LOSS_RTOL, INT8_GRAD_TOL, INT8_LOOP_LOSS_RTOL, "bf16")}
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


def device_us(fn, name, n=20):
    """Microseconds on the card per launch of the port kernel ``name`` (see
    PORT_KERNELS), from torch.profiler over ``n`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(is_kernel(name, k, e.key) for k in PORT_KERNELS[name])]
    if not hits:
        raise AssertionError(f"the profiler saw no kernel of {name!r}")
    return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits)


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their rate (float32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
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
    q, kp, vp, pos, tab, q_pos = paged_case(S, 3, 3, 64, 16, 20, DECODE_LENS,
                                            torch.float32, torch.float32, 99)
    return dict(name="flash_decode",
                shape="q (4, 9, 64) f32, pools (83, 16, 3, 64) f32, live lens "
                      + ",".join(map(str, DECODE_LENS)),
                **decode_row(ops, F, "flash_decode", (q, kp, vp, pos, tab, q_pos)))


DECODE_LENS = [120, 200, 260, 310]   # the timed B8 shape's live lengths


def gathered_kv(kp, vp, scales, tab, b, L, P):
    """Slot b's first L entries as contiguous (1, K, L, d) f32 K and V,
    dequantized when ``scales`` are given (the library yardstick's inputs:
    the gather is not timed), and their page ids."""
    t = torch.arange(L, device="cuda")
    page = tab[b, t // P].long()
    k, v = kp[page, t % P].float(), vp[page, t % P].float()
    if scales is not None:
        k = k * scales["k_scale"][page][:, :, None]
        v = v * scales["v_scale"][page][:, :, None]
    return (k.permute(1, 0, 2)[None].contiguous(), v.permute(1, 0, 2)[None].contiguous(),
            page)


def pool_bytes_read(tokens, pages, K, d, itemsize, scales):
    """Bytes a paged decode must read of the pools: live K and V, their
    scales (int8 pools), positions and table entries."""
    return (2 * tokens * K * d * itemsize + (2 * pages * K * 4 if scales else 0)
            + tokens * 4 + pages * 4)


def decode_row(ops, F, name, args, scales=None):
    """B8's time (over f32 pools, or int8 pools with ``scales``) at the
    decode shape DECODE_LENS, beside its plain version, SDPA over the
    pre-gathered (dequantized) K/V of the same live lengths (attention only)
    and its bound."""
    q, kp, vp, pos, tab, q_pos = args
    S, K, d, P = q.shape[0], kp.shape[2], kp.shape[3], kp.shape[1]
    kw = dict(scale=0.125, **(scales or {}))
    err = (ops.decode_attention(*args, impl="kernel", **kw)
           - ops.decode_attention(*args, impl="ref", **kw)).abs().max().item()
    ms = cuda_ms(lambda: ops.decode_attention(*args, impl="kernel", **kw))
    plain_ms = cuda_ms(lambda: ops.decode_attention(*args, impl="ref", **kw))
    dev_us = device_us(lambda: ops.decode_attention(*args, impl="kernel", **kw), name)
    T = max(DECODE_LENS)
    kk = torch.zeros(S, K, T, d, device="cuda")
    vv = torch.zeros(S, K, T, d, device="cuda")
    mask = torch.zeros(S, 1, 1, T, dtype=torch.bool, device="cuda")
    for b, L in enumerate(DECODE_LENS):
        kb, vb, _ = gathered_kv(kp, vp, scales, tab, b, L, P)
        kk[b, :, :L], vv[b, :, :L] = kb[0], vb[0]
        mask[b, ..., :L] = True
    qq = q[:, :, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=0.125, enable_gqa=True))
    H = q.shape[1]
    pages = sum(min(tab.shape[1], (L - 1) // P + 1) for L in DECODE_LENS)
    tokens = pages * P
    nbytes = (pool_bytes_read(tokens, pages, K, d, kp.element_size(), scales)
              + 2 * q.numel() * q.element_size() + S * 4)      # q, out, q_pos
    flops = 4 * H * d * tokens + (2 * K * d * tokens if scales else 0)  # + dequantization
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"[kernels] {name} at the decode shape: {ms:.5f} ms ({dev_us:.2f} us on the "
        f"card), plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, {flops} flops)")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:44",
        max_abs_err=err, ms=ms, device_us=dev_us, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="torch.nn.functional.scaled_dot_product_attention over pre-gathered "
                + ("dequantized " if scales else "") + "K/V (attention only)",
    )


def multi_case(B, T, K, G, d, P, C, hist, q_dtype, kv_dtype, seed, dead=(),
               share=False):
    """Slot b holds hist[b] tokens of history and a T-token chunk after them
    (positions hist[b] .. hist[b] + T - 1), written through a permuted page
    table; stale random bytes elsewhere.  ``dead`` (b, t) rows sit at
    q_pos -1 (their chunk entries are not written).  With ``share`` slot 1's
    first two table entries map slot 0's pages (a prefix shared through the
    cache: slot 1's first 2P tokens are slot 0's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N = B * C + 3
    q = torch.randn(B, T, K * G, d, device="cuda", generator=gen).to(q_dtype)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    perm = torch.randperm(N, device="cuda", generator=gen)
    tab = perm[:B * C].reshape(B, C).to(torch.int32)
    if share:
        tab[1, :2] = tab[0, :2]
    q_pos = torch.stack([torch.arange(h, h + T, device="cuda") for h in hist]).to(torch.int32)
    for b, t in dead:
        q_pos[b, t] = -1
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, h in enumerate(hist):
        t = torch.arange(h, device="cuda")
        if share and b == 1:
            t = t[t >= 2 * P]             # slot 0 wrote the shared span
        t = torch.cat([t, q_pos[b][q_pos[b] >= 0].long()])
        pos[tab[b, t // P].long(), t % P] = t.to(torch.int32)
    return q, kp, vp, pos, tab, q_pos


def check_multi_cases(ops, da):
    """B9 against its plain version on the card (f32 atol 2e-5, bf16 2e-2),
    rows at q_pos -1 exactly zero; T = 1 against B8 on the same inputs.
    Returns the worst error per tier."""
    from repro_torch.kernels import build

    lib = build.library()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (label, B, T, K, G, hist, q_dtype, kv_dtype, window, softcap, dead, share)
        ("engine chunk", 1, 64, 3, 3, [100], f32, f32, 0, 0.0, (), False),
        ("engine chunk bf16", 1, 64, 3, 3, [192], bf16, bf16, 0, 0.0, (), False),
        ("last chunk of a 200-token prompt (rows past it at -1)", 1, 64, 3, 3,
         [192], f32, f32, 0, 0.0, tuple((0, t) for t in range(8, 64)), False),
        ("T not a multiple of the row tile", 8, 37, 3, 3,
         [0, 5, 16, 100, 200, 31, 64, 2], f32, f32, 0, 0.0, ((0, 36), (3, 0)), False),
        ("speculative-verify shape", 4, 5, 3, 3, [70, 0, 250, 33], f32, f32, 0, 0.0,
         tuple((1, t) for t in range(5)), False),
        ("MHA", 2, 9, 9, 1, [40, 3], f32, f32, 0, 0.0, ((1, 8),), False),
        ("MQA", 2, 9, 1, 9, [40, 3], f32, f32, 0, 0.0, ((0, 0),), False),
        ("window", 2, 24, 3, 3, [100, 3], f32, f32, 48, 0.0, (), False),
        ("softcap", 2, 24, 3, 3, [100, 3], f32, f32, 0, 20.0, (), False),
        ("window + softcap bf16", 2, 24, 3, 3, [100, 3], bf16, bf16, 48, 20.0, (), False),
        ("f32 q over bf16 pools", 2, 24, 3, 3, [100, 3], f32, bf16, 0, 0.0, (), False),
        ("two slots share pages", 2, 12, 3, 3, [80, 80], f32, f32, 0, 0.0, (), True),
    ]
    worst = {f32: 0.0, bf16: 0.0}
    d = 64
    for i, case in enumerate(cases):
        label, B, T, K, G, hist, qdt, kvdt, window, cap, dead, share = case
        args = multi_case(B, T, K, G, d, 16, 20, hist, qdt, kvdt, 100 + i, dead, share)
        kw = dict(scale=0.125, window=window, softcap=cap)
        got = ops.decode_attention_multi(*args, impl="kernel", **kw)
        want = ops.decode_attention_multi(*args, impl="ref", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tier = bf16 if bf16 in (qdt, kvdt) else f32
        worst[tier] = max(worst[tier], err)
        dead_nonzero = sum(int(torch.count_nonzero(got[b, t])) for b, t in dead)
        if not err <= ATOL[tier] or dead_nonzero:
            raise AssertionError(f"flash_decode_multi case {label!r}: max err {err}, "
                                 f"{dead_nonzero} nonzero entries in rows at -1")
        tq = lib.repro_flash_decode_multi_rows(B, K, T, G, d, 16)
        if label.startswith("T not a multiple") and T % tq == 0:
            raise AssertionError(f"{label}: the row tile {tq} divides T={T}")
        log(f"[kernels] flash_decode_multi {label}: max err {err:.3g} (atol "
            f"{ATOL[tier]}), {T // tq + (T % tq > 0)} tiles of {tq} queries, "
            f"{len(dead)} rows at -1 exactly zero")

    # T = 1 against B8 on the same inputs
    q, kp, vp, pos, tab, q_pos = multi_case(4, 1, 3, 3, 64, 16, 20, [57, 0, 300, 16],
                                            f32, f32, 77, ((1, 0),))
    got = ops.decode_attention_multi(q, kp, vp, pos, tab, q_pos, scale=0.125,
                                     impl="kernel")[:, 0]
    b8 = ops.decode_attention(q[:, 0].contiguous(), kp, vp, pos, tab,
                              q_pos[:, 0].contiguous(), scale=0.125, impl="kernel")
    torch.cuda.synchronize()
    err = (got - b8).abs().max().item()
    if not err <= ATOL[f32] or torch.count_nonzero(got[1]) != 0:
        raise AssertionError(f"flash_decode_multi at T=1 against B8: max err {err}")
    log(f"[kernels] flash_decode_multi T=1 against flash_decode (B8): max err {err:.3g}")
    return worst


def multi_phase(ops, da, F):
    """B9's checks, then its time at the dynamic serve's chunk shape: one
    slot, a 64-token chunk at positions 192..255 (the last chunk of a
    256-token prompt), smollm-135m's 9/3 heads of 64, 16 live pages of 16."""
    worst = check_multi_cases(ops, da)
    args = multi_case(1, 64, 3, 3, 64, 16, 20, [192], torch.float32, torch.float32, 99)
    return dict(name="flash_decode_multi",
                shape="q (1, 64, 9, 64) f32 at positions 192..255, pools (23, 16, 3, "
                      "64) f32, 16 live pages",
                worst_err_f32=worst[torch.float32], worst_err_bf16=worst[torch.bfloat16],
                **multi_row(ops, F, "flash_decode_multi", args))


def multi_row(ops, F, name, args, scales=None):
    """B9's time (over f32 pools, or int8 pools with ``scales``) at the
    dynamic serve's chunk shape, beside its plain version, SDPA over the
    slot's pre-gathered (dequantized) live K/V with the boolean position
    mask (attention only) and its bound (the (row, token) pairs visible)."""
    q, kp, vp, pos, tab, q_pos = args
    T, H, d = q.shape[1:]
    K, P = kp.shape[2], kp.shape[1]
    kw = dict(scale=0.125, **(scales or {}))
    err = (ops.decode_attention_multi(*args, impl="kernel", **kw)
           - ops.decode_attention_multi(*args, impl="ref", **kw)).abs().max().item()
    ms = cuda_ms(lambda: ops.decode_attention_multi(*args, impl="kernel", **kw))
    plain_ms = cuda_ms(lambda: ops.decode_attention_multi(*args, impl="ref", **kw))
    dev_us = device_us(lambda: ops.decode_attention_multi(*args, impl="kernel", **kw),
                       name)
    L = int(q_pos.max()) + 1
    kk, vv, page = gathered_kv(kp, vp, scales, tab, 0, L, P)
    kv_pos = pos[page, torch.arange(L, device="cuda") % P]
    mask = (kv_pos[None, :] >= 0) & (kv_pos[None, :] <= q_pos[0][:, None])   # (T, L)
    qq = q.permute(0, 2, 1, 3).contiguous()                                # (1, H, T, d)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask[None, None], scale=0.125, enable_gqa=True))
    pages = (L - 1) // P + 1
    tokens = pages * P
    visible = int(mask.sum())                   # (row, token) pairs this chunk needs
    nbytes = (pool_bytes_read(tokens, pages, K, d, kp.element_size(), scales)
              + 2 * q.numel() * q.element_size() + T * 4)     # q, out, q_pos
    flops = 4 * H * d * visible + (2 * K * d * tokens if scales else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"[kernels] {name} at the chunk shape: {ms:.5f} ms ({dev_us:.2f} us on the "
        f"card), plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {bound_ms:.6f} "
        f"ms ({bound_by}: {nbytes} bytes, {flops} flops over {visible} visible pairs)")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:113",
        max_abs_err=err, ms=ms, device_us=dev_us, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="torch.nn.functional.scaled_dot_product_attention over pre-gathered "
                + ("dequantized " if scales else "")
                + "K/V with the boolean position mask (attention only)",
    )


def int8_pools(kp, vp, seed):
    """int8 pools and their (N, K) scales from f32 pools, each page and kv
    head first scaled by its own factor in [0.1, 3.1) so that the scales
    differ (quant.pack_kv: absmax/127 over the page)."""
    from repro_torch import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, _, K, _ = kp.shape
    f = 0.1 + 3 * torch.rand(2, N, 1, K, 1, device="cuda", generator=gen)
    kq, vq, ks, vs = quant.pack_kv(kp.float() * f[0], vp.float() * f[1])
    return kq, vq, dict(k_scale=ks, v_scale=vs)


def check_int8_decode_cases(ops):
    """B8's int8 mode against its plain version on the card (f32 q at atol
    2e-5, bf16 q at 2e-2), inactive slots exactly zero.  Returns the worst
    error per q dtype."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (label, B, K, G, lens, q_dtype, window, softcap)
        ("engine shape", 4, 3, 3, [120, 200, 260, 310], f32, 0, 0.0),
        ("engine shape, an inactive slot", 4, 3, 3, [57, 0, 320, 16], f32, 0, 0.0),
        ("bf16 q", 4, 3, 3, [300, 45, 0, 128], bf16, 0, 0.0),
        ("MHA, half page", 4, 9, 1, [9, 0, 160, 300], f32, 0, 0.0),
        ("MQA, half page", 4, 1, 9, [0, 41, 320, 72], f32, 0, 0.0),
        ("window", 4, 3, 3, [300, 45, 0, 128], f32, 100, 0.0),
        ("softcap", 4, 3, 3, [300, 45, 0, 128], f32, 0, 30.0),
        ("window + softcap, bf16 q", 4, 3, 3, [300, 45, 0, 128], bf16, 64, 20.0),
    ]
    worst = {f32: 0.0, bf16: 0.0}
    for i, (label, B, K, G, lens, qdt, window, cap) in enumerate(cases):
        q, kp, vp, pos, tab, q_pos = paged_case(B, K, G, 64, 16, 20, lens, qdt,
                                                torch.float32, 200 + i)
        kq, vq, scales = int8_pools(kp, vp, 200 + i)
        kw = dict(scale=0.125, window=window, softcap=cap, **scales)
        got = ops.decode_attention(q, kq, vq, pos, tab, q_pos, impl="kernel", **kw)
        want = ops.decode_attention(q, kq, vq, pos, tab, q_pos, impl="ref", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst[qdt] = max(worst[qdt], err)
        n_dead = int((q_pos < 0).sum())
        if not err <= ATOL[qdt] or torch.count_nonzero(got[q_pos < 0]) != 0:
            raise AssertionError(f"flash_decode int8 case {label!r}: max err {err}")
        log(f"[kernels] flash_decode int8 {label}: max err {err:.3g} (atol "
            f"{ATOL[qdt]}), {n_dead} inactive slots exactly zero")
    return worst


def check_int8_multi_cases(ops):
    """B9's int8 mode against its plain version on the card (f32 q at atol
    2e-5, bf16 q at 2e-2), rows at q_pos -1 exactly zero; at T = 1 against
    B8's int8 mode on the same inputs.  Returns the worst error per q
    dtype."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (label, B, T, K, G, hist, q_dtype, window, softcap, dead, share)
        ("engine chunk, history resident", 1, 64, 3, 3, [128], f32, 0, 0.0, (), False),
        ("engine chunk, bf16 q", 1, 64, 3, 3, [192], bf16, 0, 0.0, (), False),
        ("last chunk of a 200-token prompt (rows past it at -1)", 1, 64, 3, 3,
         [192], f32, 0, 0.0, tuple((0, t) for t in range(8, 64)), False),
        ("speculative-verify shape", 4, 5, 3, 3, [70, 0, 250, 33], f32, 0, 0.0,
         tuple((1, t) for t in range(5)), False),
        ("MHA", 2, 9, 9, 1, [40, 3], f32, 0, 0.0, ((1, 8),), False),
        ("MQA", 2, 9, 1, 9, [40, 3], f32, 0, 0.0, ((0, 0),), False),
        ("window + softcap", 2, 24, 3, 3, [100, 3], f32, 48, 20.0, (), False),
        ("two slots share pages", 2, 12, 3, 3, [80, 80], f32, 0, 0.0, (), True),
    ]
    worst = {f32: 0.0, bf16: 0.0}
    for i, case in enumerate(cases):
        label, B, T, K, G, hist, qdt, window, cap, dead, share = case
        q, kp, vp, pos, tab, q_pos = multi_case(B, T, K, G, 64, 16, 20, hist, qdt,
                                                torch.float32, 300 + i, dead, share)
        kq, vq, scales = int8_pools(kp, vp, 300 + i)
        kw = dict(scale=0.125, window=window, softcap=cap, **scales)
        got = ops.decode_attention_multi(q, kq, vq, pos, tab, q_pos, impl="kernel", **kw)
        want = ops.decode_attention_multi(q, kq, vq, pos, tab, q_pos, impl="ref", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst[qdt] = max(worst[qdt], err)
        dead_nonzero = sum(int(torch.count_nonzero(got[b, t])) for b, t in dead)
        if not err <= ATOL[qdt] or dead_nonzero:
            raise AssertionError(f"flash_decode_multi int8 case {label!r}: max err "
                                 f"{err}, {dead_nonzero} nonzero entries in rows at -1")
        log(f"[kernels] flash_decode_multi int8 {label}: max err {err:.3g} (atol "
            f"{ATOL[qdt]}), {len(dead)} rows at -1 exactly zero")

    # T = 1 against B8's int8 mode on the same inputs
    q, kp, vp, pos, tab, q_pos = multi_case(4, 1, 3, 3, 64, 16, 20, [57, 0, 300, 16],
                                            f32, f32, 377, ((1, 0),))
    kq, vq, scales = int8_pools(kp, vp, 377)
    got = ops.decode_attention_multi(q, kq, vq, pos, tab, q_pos, scale=0.125,
                                     impl="kernel", **scales)[:, 0]
    b8 = ops.decode_attention(q[:, 0].contiguous(), kq, vq, pos, tab,
                              q_pos[:, 0].contiguous(), scale=0.125, impl="kernel",
                              **scales)
    torch.cuda.synchronize()
    err = (got - b8).abs().max().item()
    if not err <= ATOL[f32] or torch.count_nonzero(got[1]) != 0:
        raise AssertionError(f"flash_decode_multi int8 at T=1 against B8 int8: max err {err}")
    log(f"[kernels] flash_decode_multi int8 T=1 against flash_decode int8 (B8): "
        f"max err {err:.3g}")
    worst["t1_vs_b8"] = err
    return worst


def int8_decode_phase(ops, F):
    """B8's int8 checks, then its time at the decode shape (decode_row)."""
    worst = check_int8_decode_cases(ops)
    q, kp, vp, pos, tab, q_pos = paged_case(4, 3, 3, 64, 16, 20, DECODE_LENS,
                                            torch.float32, torch.float32, 99)
    kq, vq, scales = int8_pools(kp, vp, 99)
    return dict(name="flash_decode_int8",
                shape="q (4, 9, 64) f32, pools (83, 16, 3, 64) int8 + (83, 3) f32 "
                      "scales, live lens " + ",".join(map(str, DECODE_LENS)),
                worst_err_f32=worst[torch.float32], worst_err_bf16=worst[torch.bfloat16],
                **decode_row(ops, F, "flash_decode_int8", (q, kq, vq, pos, tab, q_pos),
                             scales))


def int8_multi_phase(ops, F):
    """B9's int8 checks, then its time at the chunk shape (multi_row)."""
    worst = check_int8_multi_cases(ops)
    q, kp, vp, pos, tab, q_pos = multi_case(1, 64, 3, 3, 64, 16, 20, [192],
                                            torch.float32, torch.float32, 99)
    kq, vq, scales = int8_pools(kp, vp, 98)
    return dict(name="flash_decode_multi_int8",
                shape="q (1, 64, 9, 64) f32 at positions 192..255, pools (23, 16, 3, "
                      "64) int8 + (23, 3) f32 scales, 16 live pages",
                worst_err_f32=worst[torch.float32], worst_err_bf16=worst[torch.bfloat16],
                t1_vs_b8_err=worst["t1_vs_b8"],
                **multi_row(ops, F, "flash_decode_multi_int8",
                            (q, kq, vq, pos, tab, q_pos), scales))


def check_close(what, got, want, atol, rtol=0.0):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return the
    max abs error."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    err = diff.max().item()
    if not excess <= 0:
        raise AssertionError(f"{what}: max abs err {err} (atol {atol}, rtol {rtol})")
    return err


def check_rounded(what, name, got, want, limits=FLASH_MAX_TOL):
    """Raise unless output ``name``'s max |got - want| <= limits[name] and
    its mean <= FLASH_MEAN_TOL; return (max, mean)."""
    err = rounded_err(got, want)
    if not rounds_like(name, err, limits):
        raise AssertionError(f"{what} {name}: max abs err {err[0]} (limit "
                             f"{limits[name]}), mean {err[1]} (limit "
                             f"{FLASH_MEAN_TOL})")
    return err


def rounds_like(name, err, limits=FLASH_MAX_TOL):
    return err[0] <= limits[name] and err[1] <= FLASH_MEAN_TOL


def rounded_err(got, want):
    """(max, mean) of |got - want|."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), diff.mean().item()


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

# B5-B7: label, B, S, H, K, d, window, softcap, scale, storage dtype
FLASH_CASES = [
    ("train shape", 8, 512, 16, 16, 64, 0, 0.0, 0.125, torch.float32),
    ("smollm heads 9/3 (GQA)", 4, 256, 9, 3, 64, 0, 0.0, 0.125, torch.float32),
    ("window 48", 2, 384, 4, 2, 64, 48, 0.0, 0.125, torch.float32),
    # scale 0.5: logits of std 4, up to ~20, which the cap bends hard
    ("softcap 20", 2, 256, 4, 2, 64, 0, 20.0, 0.5, torch.float32),
    ("ragged S 200", 3, 200, 6, 2, 64, 0, 0.0, 0.125, torch.float32),
    ("bf16 storage", 2, 256, 8, 4, 64, 0, 0.0, 0.125, torch.bfloat16),
    ("d_head 128, ragged S 190", 1, 190, 4, 4, 128, 0, 0.0, 0.125, torch.float32),
]
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_OUTS = ("o", "lse", "dq", "dk", "dv")


def flash_inputs(B, S, H, K, d, dt, seed):
    """q, k, v and a cotangent do of order 1 (standard normal)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, K, d, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    return q, k, v, do


def flash_pair(fa, ref, qs, k, v, do, **kw):
    """(o, lse, dq, dk, dv) of B5, B6 and B7, and of their plain versions
    (kernels/ref.py: flash_fwd_ref, flash_bwd_ref) on the same inputs: the
    backward pair both take the kernel forward's lse and delta = rowsum(do
    * o), as ops.attention's Function forms it."""
    o, lse = fa.flash_fwd(qs, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(qs, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **kw)
    plain = (*ref.flash_fwd_ref(qs, k, v, **kw),
             *ref.flash_bwd_ref(qs, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    return (o, lse, dq, dk, dv), plain, delta


@contextlib.contextmanager
def int8_tiles(ref, width):
    """While open, the plain versions tile ``width`` wide in the int8 mode
    (ref.FLASH_TILES): the control with the wrong tiles."""
    saved = {k: dict(v) for k, v in ref.FLASH_TILES.items()}
    for kernel in ref.FLASH_TILES:
        ref.FLASH_TILES[kernel]["int8"] = (width, width)
    try:
        yield
    finally:
        for kernel, modes in saved.items():
            ref.FLASH_TILES[kernel].update(modes)


def flash_case(ops, fa, ref, quant, case, seed):
    """One FLASH_CASES row.  Per operand mode, each kernel against its plain
    version: lse at the f32 tier always; o and dq/dk/dv at the f32 tiers
    where nothing rounds to bf16, else by check_rounded (the bf16 tiers, or
    the int8 one, for the max).  The controls: the f32-mode kernel outputs
    must fail the bf16 mode's check, and the int8-mode kernel outputs must
    fail the int8 check against the plain versions tiled 64 wide.  Then the
    autograd Function (scale fold, delta, casts) in the f32 mode against the
    plain attention under autograd, and the bf16 and int8 modes' distance
    from the policy's plain attention (printed, not held: that one rounds or
    quantizes the normalized p over whole rows, and forms delta from the
    rounded do and v)."""
    label, B, S, H, K, d, window, cap, scale, dt = case
    q, k, v, do = flash_inputs(B, S, H, K, d, dt, seed)
    qs = (q.float() * scale).to(dt)
    kw = dict(causal=True, window=window, softcap=cap)
    f32 = dt == torch.float32
    got, out = {}, {}
    for mode in FLASH_MODES:
        policy = quant.QuantPolicy(mode)
        limits = INT8_MAX_TOL if mode == "int8" else FLASH_MAX_TOL
        got[mode], want, delta = flash_pair(fa, ref, qs, k, v, do, policy=policy, **kw)
        what = f"flash attention {label}, {mode} operands"
        e = {"lse": check_close(what + " lse", got[mode][1], want[1], 2e-5, 1e-5)}
        if mode == "none" and f32:
            e["o"] = check_close(what + " o", got[mode][0], want[0], ATOL[dt])
        else:
            e["o"], e["o_mean"] = check_rounded(what, "o", got[mode][0], want[0], limits)
        for name, g, w in zip(("dq", "dk", "dv"), got[mode][2:], want[2:]):
            if mode == "none":
                e[name] = check_close(f"{what} {name}", g, w, *GRAD_TOL[torch.float32])
            else:
                e[name], e[name + "_mean"] = check_rounded(what, name, g, w, limits)
        again = fa.flash_bwd_dkv(qs, k, v, do, got[mode][1], delta, policy=policy, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got[mode][3:], again)):
            raise AssertionError(f"{what}: dk/dv differ between two calls")
        control = None
        if mode == "bf16":
            control = {n: rounded_err(g, w) for n, g, w in
                       zip(FLASH_OUTS, got["none"], want) if n != "lse"}
        elif mode == "int8":
            with int8_tiles(ref, 64):
                _, lse, _, _, _ = got[mode]
                wrong = (ref.flash_fwd_ref(qs, k, v, policy=policy, **kw)[0],
                         *ref.flash_bwd_ref(qs, k, v, do, lse, delta, policy=policy, **kw))
            control = {n: rounded_err(g, w) for n, g, w in
                       zip(("o", "dq", "dk", "dv"), got[mode][:1] + got[mode][2:], wrong)}
            del wrong
        if control is not None:
            passed = [n for n, c in control.items() if rounds_like(n, c, limits)]
            if passed:
                raise AssertionError(f"{what}: the control's outputs {passed} pass the "
                                     f"{mode} check: {control}")
            e["control_mean"] = {n: c[1] for n, c in control.items()}
        out[mode] = e
        del want, delta, again

    # the autograd Function, kernels against the plain attention under autograd
    for mode in FLASH_MODES:
        policy = quant.QuantPolicy(mode)
        res = {}
        for impl in ("kernel", "ref"):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = ops.attention(*leaves, impl=impl, scale=scale, policy=policy, **kw)
            res[impl] = [o.detach(), *torch.autograd.grad(o, leaves, do)]
        for g in res["kernel"][1:]:
            if g.dtype != dt:
                raise AssertionError(f"flash attention {label}: a gradient is {g.dtype}")
        what = f"flash attention {label} through ops.attention, {mode} operands"
        if mode == "none":
            tier = torch.float32 if f32 else torch.bfloat16
            check_close(what + " o", res["kernel"][0], res["ref"][0], ATOL[tier])
            for name, g, w in zip(("dq", "dk", "dv"), res["kernel"][1:], res["ref"][1:]):
                check_close(f"{what} {name}", g, w, *GRAD_TOL[tier])
        else:
            out[mode]["vs_policy_plain"] = [rounded_err(g, w)[0] for g, w in
                                            zip(res["kernel"], res["ref"])]
        del res
    e0 = out["none"]
    text = (f"[kernels] flash attention {label}, {str(dt)[6:]} storage: f32 operands max "
            f"err o {e0['o']:.3g}, lse {e0['lse']:.3g}, dq {e0['dq']:.3g}, dk "
            f"{e0['dk']:.3g}, dv {e0['dv']:.3g}")
    controls = {"bf16": "f32-mode outputs against the bf16 plain version",
                "int8": "int8 outputs against the plain version tiled 64 wide"}
    for mode in FLASH_MODES[1:]:
        e1 = out[mode]
        text += (f"; {mode} operands max / mean err o {e1['o']:.3g} / {e1['o_mean']:.3g}, "
                 f"lse {e1['lse']:.3g}, "
                 + ", ".join(f"{n} {e1[n]:.3g} / {e1[n + '_mean']:.3g}"
                             for n in ("dq", "dk", "dv"))
                 + f"; control ({controls[mode]}) mean err "
                 + ", ".join(f"{n} {c:.3g}" for n, c in e1["control_mean"].items())
                 + f"; {mode} through ops.attention against the policy's plain attention, "
                 "max " + ", ".join(f"{n} {c:.3g}" for n, c in
                                    zip(("o", "dq", "dk", "dv"), e1["vs_policy_plain"])))
    log(text)
    return out


def flash_phase(ops, fa, ref, quant, F):
    """B5-B7 against their plain versions in the three operand modes (see
    flash_case); timed at the train shape, with the card's time per launch
    of the int8 kernels."""
    errs = {}
    for i, case in enumerate(FLASH_CASES):
        errs[case[0]] = flash_case(ops, fa, ref, quant, case, i)
        torch.cuda.empty_cache()
    worst = {m: max(max(e[m][n] for n in ("o", "dq", "dk", "dv")) for e in errs.values())
             for m in FLASH_MODES}
    worst_mean = {m: max(e[m][n + "_mean"] for e in errs.values()
                         for n in ("o", "dq", "dk", "dv")) for m in FLASH_MODES[1:]}
    least_control = {m: min(c for e in errs.values() for c in e[m]["control_mean"].values())
                     for m in FLASH_MODES[1:]}
    log(f"[kernels] flash attention: {len(FLASH_CASES)} cases x {len(FLASH_MODES)} operand "
        f"modes agree, dk/dv deterministic; worst max err f32 operands "
        f"{worst['none']:.3g}, bf16 operands {worst['bf16']:.3g} (limits {FLASH_MAX_TOL}), "
        f"int8 operands {worst['int8']:.3g} (limits {INT8_MAX_TOL}); worst mean err "
        + ", ".join(f"{m} {v:.3g}" for m, v in worst_mean.items())
        + f" (limit {FLASH_MEAN_TOL}); least control mean err "
        + ", ".join(f"{m} {v:.3g}" for m, v in least_control.items()))

    # timing at the train shape: B 8, S 512, 16 heads of 64, causal, f32
    _, B, S, H, K, d, _, _, scale, dt = FLASH_CASES[0]
    q, k, v, do = flash_inputs(B, S, H, K, d, dt, 100)
    qs = (q * scale).contiguous()
    pairs = B * H * S * (S + 1) // 2          # visible (query, key) pairs
    io = q.numel() * 4                        # one (B, S, H, d) f32 tensor
    rows = B * H * S * 4                      # one (B, H, S) f32 tensor
    work = {  # bytes each kernel must move, and its tile-matmul operations
        "flash_fwd": (3 * io + io + rows, 4 * d * pairs),
        "flash_bwd_dq": (4 * io + 2 * rows + io, 6 * d * pairs),
        "flash_bwd_dkv": (4 * io + 2 * rows + 2 * io, 8 * d * pairs),
    }
    # the library yardstick: SDPA on bf16 q/k/v in its (B, H, S, d) layout
    qb, kb, vb, dob = (t.transpose(1, 2).bfloat16().contiguous().requires_grad_(t is not do)
                       for t in (q, k, v, do))
    sdpa = lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True, scale=scale)
    ob = sdpa()
    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True))
    lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qb, kb, vb), dob))
    rates = {"none": F32_FLOP_PER_S, "bf16": BF16_TC_FLOP_PER_S, "int8": INT8_TC_OP_PER_S}
    timed = {}
    for mode in ("bf16", "int8", "none"):
        policy = quant.QuantPolicy(mode)
        pol = policy if policy.active else None
        fkw = dict(causal=True, policy=pol)
        o, lse = fa.flash_fwd(qs, k, v, **fkw)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain = lambda: ops.attention(*leaves, scale=scale, policy=policy, impl="ref")
        op = plain()
        calls = {
            "flash_fwd": lambda: fa.flash_fwd(qs, k, v, **fkw),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(qs, k, v, do, lse, delta, **fkw),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **fkw),
        }
        t = {n: cuda_ms(fn) for n, fn in calls.items()}
        dev = ({n: device_us(fn, n + "_int8") for n, fn in calls.items()}
               if mode == "int8" else {})
        with torch.no_grad():
            p_fwd = cuda_ms(lambda: plain(), n=20)
        p_dq = cuda_ms(lambda: torch.autograd.grad(op, leaves[0], do, retain_graph=True), n=20)
        p_dkv = cuda_ms(lambda: torch.autograd.grad(op, leaves[1:], do, retain_graph=True), n=20)
        b = {n: bound(*work[n], rates[mode]) for n in FLASH_NAMES}
        timed[mode] = dict(ms=t, device_us=dev, plain={"flash_fwd": p_fwd, "flash_bwd_dq": p_dq,
                                                      "flash_bwd_dkv": p_dkv}, bound=b)
        log(f"[kernels] flash attention (8, 512, 16, 64) causal f32, {mode} operands: "
            + "; ".join(f"{n} {t[n]:.4f} ms (plain {timed[mode]['plain'][n]:.4f}, "
                        f"bound {b[n][0]:.4f} by {b[n][1]}"
                        + (f", {dev[n]:.2f} us on the card" if dev else "") + ")"
                        for n in FLASH_NAMES))
        del o, lse, delta, leaves, op
        torch.cuda.empty_cache()
    log(f"[kernels] SDPA bf16 causal (8, 16, 512, 64): forward {lib_fwd:.4f} ms, "
        f"backward {lib_bwd:.4f} ms, forward + backward {lib_fwd_bwd:.4f} ms")

    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  shape="q, k, v, do (8, 512, 16, 64) f32, causal; bf16 operands "
                        "(the --amp bf16 path)")
    lines = {"flash_fwd": ("src/repro/kernels/flash_attention.py:77", lib_fwd,
                           "torch.nn.functional.scaled_dot_product_attention(is_causal"
                           "=True), bf16 q/k/v, forward"),
             "flash_bwd_dq": ("src/repro/kernels/flash_attention.py:158", lib_fwd_bwd,
                              "SDPA bf16 forward + backward (dq, dk, dv together)"),
             "flash_bwd_dkv": ("src/repro/kernels/flash_attention.py:194", lib_fwd_bwd,
                               "SDPA bf16 forward + backward (dq, dk, dv together)")}
    err_at = {"flash_fwd": ["o", "lse"], "flash_bwd_dq": ["dq"], "flash_bwd_dkv": ["dk", "dv"]}
    out = []
    for n in FLASH_NAMES:
        replaces, lib_ms, lib_name = lines[n]
        bf, f32, i8 = timed["bf16"], timed["none"], timed["int8"]
        out.append(dict(
            name=n, replaces=replaces,
            max_abs_err=max(errs["train shape"]["bf16"][j] for j in err_at[n]),
            ms=bf["ms"][n], plain_ms=bf["plain"][n], bound_ms=bf["bound"][n][0],
            bound_by=bf["bound"][n][1], library_ms=lib_ms, library=lib_name,
            library_bwd_ms=None if n == "flash_fwd" else lib_bwd,
            f32_operands=dict(
                ms=f32["ms"][n], plain_ms=f32["plain"][n], bound_ms=f32["bound"][n][0],
                bound_by=f32["bound"][n][1],
                max_abs_err=max(errs["train shape"]["none"][j] for j in err_at[n])),
            **common))
        out.append(dict(
            name=n + "_int8", replaces=f"{replaces} (int8 operands: kernel_dot, "
                                      "src/repro/quant/core.py:63-67)",
            max_abs_err=max(errs["train shape"]["int8"][j] for j in err_at[n]),
            ms=i8["ms"][n], device_us=i8["device_us"][n], plain_ms=i8["plain"][n],
            bound_ms=i8["bound"][n][0], bound_by=i8["bound"][n][1], library_ms=None,
            library="none: no PyTorch call computes int8-operand attention",
            sdpa_bf16_ms_for_scale=lib_ms,
            **dict(common, shape="q, k, v, do (8, 512, 16, 64) f32, causal; int8 operands "
                                 "(the --amp int8 path)")))
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def make_recording_model(Model):
    class RecordingModel(Model):
        """Keeps, for every forward the engine runs, its mode and width, the
        top-2 logits of the rows it samples from (a chunk's last real row),
        and the full rows of the first 8 single-token decodes.  Forwards
        without positions (the tie oracle's) are not recorded."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            self.n_decode = 0

        def forward(self, params, tokens, positions=None, mode="train", **kw):
            logits, cache = super().forward(params, tokens, positions=positions,
                                            mode=mode, **kw)
            if positions is None:
                return logits, cache
            T = tokens.shape[1]
            if mode == "prefill":
                plen = int((positions[0] < positions.shape[1]).sum())
                rows = logits[:, plen - 1]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            elif T > 1:
                last = int((positions[0] >= 0).sum()) - 1
                rows = logits[:, max(last, 0)]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            else:
                rows = logits[:, 0]
                active = positions[:, 0] >= 0
            top2 = rows.float().topk(2, dim=-1)
            single = mode == "decode" and T == 1
            keep = single and self.n_decode < 8
            self.n_decode += single
            self.calls.append(dict(mode=mode, T=T, top2=top2.values,
                                   arg=top2.indices[:, 0], active=active,
                                   rows=rows.clone() if keep else None))
            return logits, cache

    return RecordingModel


def compare_calls(what, kern, plain, out_k, out_r, logit_tol=SERVE_LOGIT_TOL):
    """Two serves of one schedule, with the kernels and through the plain
    versions: the same steps and forwards, the same greedy token at every
    sampled row unless the plain top-2 gap there is below TIE_GAP (after
    which that request may differ), and the first 8 decode steps' logits
    within atol = rtol = ``logit_tol`` (None: measured, not held).  Returns
    (tie_at, worst, scale)."""
    if out_k["steps"] != out_r["steps"] or len(kern.calls) != len(plain.calls):
        raise AssertionError(f"{what}: steps differ: {out_k['steps']} vs "
                             f"{out_r['steps']}")
    tie_at = None
    for i, (ck, cr) in enumerate(zip(kern.calls, plain.calls)):
        differ = (ck["arg"] != cr["arg"]) & cr["active"]
        if bool(differ.any()):
            j = int(differ.nonzero()[0, 0])
            gap = float(cr["top2"][j, 0] - cr["top2"][j, 1])
            if gap >= TIE_GAP:
                raise AssertionError(
                    f"{what}: greedy token differs at forward {i} ({cr['mode']}, "
                    f"T={cr['T']}) row {j}, plain top-2 gap {gap}")
            log(f"[{what}] tie: forward {i} ({cr['mode']}) row {j}, plain top-2 gap "
                f"{gap:.3g} < {TIE_GAP}; later tokens of that request may differ")
            tie_at = i
            break
    if tie_at is None and not torch.equal(out_k["tokens"], out_r["tokens"]):
        raise AssertionError(f"{what}: greedy tokens differ with and without the kernels")
    worst = excess = scale = 0.0
    for ck, cr in zip(kern.calls[:tie_at], plain.calls[:tie_at]):
        if ck["rows"] is not None:
            diff = (ck["rows"] - cr["rows"]).abs()
            worst = max(worst, diff.max().item())
            scale = max(scale, cr["rows"].abs().max().item())
            # allclose: |a - b| <= atol + rtol * |b|
            if logit_tol is not None:
                excess = max(excess, (diff - logit_tol * (1 + cr["rows"].abs()))
                             .max().item())
    if not excess <= 0:
        raise AssertionError(f"{what}: decode logits differ by {worst} "
                             f"(|logit| <= {scale})")
    return tie_at, worst, scale


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
    want = {"flash_decode": L * steps, "flash_decode_multi": 0,
            "flash_decode_int8": 0, "flash_decode_multi_int8": 0,
            "rmsnorm": (2 * L + 1) * (steps + R), "rmsnorm_bwd": 0, "ce_fwd": 0, "ce_bwd": 0, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_int8": 0, "flash_bwd_dq_int8": 0, "flash_bwd_dkv_int8": 0}
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

    tie_at, worst, scale = compare_calls("serve", kern, plain, out_k, out_r)
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


def shared_prefix_workload(V, R, Pmax, seed):
    """R requests, each one of 4 system prompts of 96-160 tokens plus a
    unique suffix of 16-96 tokens, drawn from a seeded generator; all
    present at t = 0."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, V, int(rng.integers(96, 161))) for _ in range(4)]
    prompts = np.zeros((R, Pmax), np.int64)
    lens = np.zeros(R, np.int64)
    for r in range(R):
        p = np.concatenate([systems[int(rng.integers(0, 4))],
                            rng.integers(0, V, int(rng.integers(16, 97)))])
        prompts[r, :len(p)] = p
        lens[r] = len(p)
    return prompts, lens


def greedy_agree(what, oracle, params, prompts, lens, got, want):
    """Greedy tokens of two serves equal request by request, or the first
    difference in a request is a near-tie: there, a plain full-sequence
    forward over the prompt and ``want``'s tokens so far (the oracle, with
    no engine and no cache) has a top-2 gap below TIE_GAP.  Returns the
    number of requests that diverged at a tie."""
    ties = 0
    for r in range(len(lens)):
        la, lb = int(got["lengths"][r]), int(want["lengths"][r])
        a, b = got["tokens"][r, :la], want["tokens"][r, :lb]
        n = min(la, lb)
        diff = (a[:n] != b[:n]).nonzero()
        if len(diff) == 0:
            if la != lb:
                raise AssertionError(f"{what}: request {r} lengths {la} != {lb}")
            continue
        j = int(diff[0, 0])
        seq = np.concatenate([prompts[r, :lens[r]], b[:j].numpy()])
        with torch.no_grad():
            logits, _ = oracle.forward(params, torch.as_tensor(seq[None], device="cuda"))
        top2 = logits[0, -1].float().topk(2).values
        gap = float(top2[0] - top2[1])
        if gap >= TIE_GAP:
            raise AssertionError(f"{what}: request {r} differs at token {j} "
                                 f"({int(a[j])} vs {int(b[j])}), oracle top-2 gap {gap}")
        log(f"[{what}] tie: request {r} token {j}, oracle top-2 gap {gap:.3g} < "
            f"{TIE_GAP}; later tokens of that request may differ")
        ties += 1
    return ties


def dynamic_serve_phase(cfg, Model, Engine, DynamicEngine, EngineConfig, ops):
    """smollm-135m at full width through DynamicEngine: 4 slots, page 16,
    prompts up to 256, 64 tokens each, chunks of 64, prefix cache on, 16
    requests over 4 shared system prompts, all present at t = 0 (no
    arrivals: the schedule, and so the step count, does not depend on host
    speed).  Checks (a)-(e) of the module docstring."""
    R, S, Pmax, Gmax, P, CH = 16, 4, 256, 64, 16, 64
    prompts, lens = shared_prefix_workload(cfg.vocab_size, R, Pmax, seed=2)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    ecfg = EngineConfig(prefill_chunk=CH, prefix_cache=True, **kw)
    Rec = make_recording_model(Model)
    kern = Rec(cfg, device="cuda", impl="auto")
    plain = Rec(cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    log(f"[serve_dynamic] {R} requests, prompt lens {lens.tolist()}, {Gmax} tokens "
        f"each, {S} slots, page {P}, prefill_chunk {CH}, prefix cache on")

    # warm-up outside the counted run
    DynamicEngine(kern, EngineConfig(prefill_chunk=CH, prefix_cache=True, n_slots=2,
                                     page_size=P, max_prompt_len=Pmax, max_gen_len=2)
                  ).serve(params, prompts[:1], lens[:1])
    kern.calls.clear()
    kern.n_decode = 0

    engine = DynamicEngine(kern, ecfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = ops.launch_counts()

    # (e) exact launch counts, from forwards counted apart from the engine
    L = cfg.n_layers
    n_chunk = sum(c["mode"] == "decode" and c["T"] > 1 for c in kern.calls)
    n_dec = sum(c["mode"] == "decode" and c["T"] == 1 for c in kern.calls)
    n_prefill = sum(c["mode"] == "prefill" for c in kern.calls)
    cached = out_k["prefill_cached"]
    # shared spans are whole chunks (floored to prefill_chunk), so request r
    # runs ceil(plen / CH) - cached_r / CH chunk forwards
    want_chunks = int(sum(-(-int(n) // CH) for n in lens)) - cached // CH
    if cached % CH or n_chunk != want_chunks or n_prefill:
        raise AssertionError(
            f"chunk forwards {n_chunk} (prefill {n_prefill}) against the schedule "
            f"{want_chunks} from prefill_cached {cached}")
    if any(c["T"] != CH for c in kern.calls if c["mode"] == "decode" and c["T"] > 1):
        raise AssertionError("a chunk forward is not prefill_chunk wide")
    want = {"flash_decode": L * n_dec, "flash_decode_multi": L * n_chunk,
            "flash_decode_int8": 0, "flash_decode_multi_int8": 0,
            "rmsnorm": (2 * L + 1) * (n_chunk + n_dec), "rmsnorm_bwd": 0,
            "ce_fwd": 0, "ce_bwd": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0,
            "flash_fwd_int8": 0, "flash_bwd_dq_int8": 0, "flash_bwd_dkv_int8": 0}
    log(f"[serve_dynamic] kernels: {out_k['steps']} steps, {n_chunk} chunk forwards, "
        f"{n_dec} decode steps; launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    # (a) the same serve through the plain versions
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_r = DynamicEngine(plain, ecfg).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"the plain serve launched kernels: {ops.launch_counts()}")
    tie_at, worst, scale = compare_calls("serve_dynamic", kern, plain, out_k, out_r)
    n_tok = int(out_k["lengths"].sum())
    log(f"[serve_dynamic] (a) kernels: {n_tok} tokens in {wall_k:.3f} s "
        f"({n_tok / wall_k:.1f} tok/s); plain: {int(out_r['lengths'].sum())} tokens in "
        f"{wall_r:.3f} s ({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s); greedy "
        f"tokens identical: {tie_at is None}; steps identical ({out_k['steps']}); first 8 "
        f"decode steps' logits max abs diff {worst:.3g} at |logit| <= {scale:.3g}")

    # (b) the static engine on the same requests
    t0 = time.perf_counter()
    out_s = Engine(kern, EngineConfig(**kw)).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ties_b = greedy_agree("serve_dynamic (b)", plain, params, prompts, lens, out_k, out_s)
    log(f"[serve_dynamic] (b) static engine: {int(out_s['lengths'].sum())} tokens in "
        f"{wall_s:.3f} s ({int(out_s['lengths'].sum()) / wall_s:.1f} tok/s), "
        f"{out_s['steps']} steps; greedy tokens equal, {ties_b} requests past a tie")

    # (c) prefix cache off
    t0 = time.perf_counter()
    out_c = DynamicEngine(kern, EngineConfig(prefill_chunk=CH, **kw)).serve(
        params, prompts, lens)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    ties_c = greedy_agree("serve_dynamic (c)", plain, params, prompts, lens, out_k, out_c)
    if not (cached > 0 and out_c["prefill_cached"] == 0):
        raise AssertionError(f"prefill_cached {cached} with the cache, "
                             f"{out_c['prefill_cached']} without")
    log(f"[serve_dynamic] (c) prefix cache off: {int(out_c['lengths'].sum())} tokens in "
        f"{wall_c:.3f} s ({int(out_c['lengths'].sum()) / wall_c:.1f} tok/s), "
        f"{out_c['steps']} steps; greedy tokens equal, {ties_c} requests past a tie; "
        f"with the cache {cached}/{out_k['prefill_total']} prompt tokens from shared pages")

    # (d) the same requests again on the same engine: a warm cache
    t0 = time.perf_counter()
    out_w = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    ties_d = greedy_agree("serve_dynamic (d)", plain, params, prompts, lens, out_k, out_w)
    if not out_w["prefill_cached"] > cached:
        raise AssertionError(f"warm serve shared {out_w['prefill_cached']} prompt "
                             f"tokens, the cold one {cached}")
    engine.blocks.check_invariants()
    log(f"[serve_dynamic] (d) warm cache: {out_w['prefill_cached']}/"
        f"{out_w['prefill_total']} prompt tokens from shared pages (cold {cached}); "
        f"{int(out_w['lengths'].sum())} tokens in {wall_w:.3f} s "
        f"({int(out_w['lengths'].sum()) / wall_w:.1f} tok/s), {out_w['steps']} steps; "
        f"greedy tokens equal, "
        f"{ties_d} requests past a tie")
    return launches, out_k["tokens"], dict(
        requests=R, steps=out_k["steps"], chunk_forwards=n_chunk, decode_steps=n_dec,
        tokens=n_tok, wall_s=wall_k, tok_per_s=n_tok / wall_k, plain_wall_s=wall_r,
        plain_tok_per_s=int(out_r["lengths"].sum()) / wall_r,
        prefill_cached=cached, prefill_total=out_k["prefill_total"],
        warm_prefill_cached=out_w["prefill_cached"], warm_wall_s=wall_w,
        warm_steps=out_w["steps"],
        static_wall_s=wall_s, static_steps=out_s["steps"], no_cache_wall_s=wall_c,
        no_cache_steps=out_c["steps"], ties=dict(b=ties_b, c=ties_c, d=ties_d),
    )


def pool_diff(a, b):
    """Two int8 pool trees of one schedule: positions must be equal; returns
    how many int8 bytes differ and by how much, and the scales' largest
    relative difference."""
    out = dict(bytes=0, bytes_differ=0, max_byte_diff=0, scale_rel=0.0)
    for key, pa in a["groups"].items():
        pa, pb = pa["attn"], b["groups"][key]["attn"]
        if not torch.equal(pa["pos"], pb["pos"]):
            raise AssertionError(f"int8 pools {key}: positions differ")
        for n in ("k", "v"):
            d = (pa[n].int() - pb[n].int()).abs()
            out["bytes"] += d.numel()
            out["bytes_differ"] += int(torch.count_nonzero(d))
            out["max_byte_diff"] = max(out["max_byte_diff"], int(d.max()))
            sa, sb = pa[n + "_scale"], pb[n + "_scale"]
            rel = ((sa - sb).abs() / sb.abs().clamp(min=1e-30)).max().item()
            out["scale_rel"] = max(out["scale_rel"], rel)
    return out


def serve_int8_phase(cfg, Model, Engine, DynamicEngine, EngineConfig, ops, f32_dyn):
    """smollm-135m at full width with int8 paged KV pools (``--kv-dtype
    int8``): through DynamicEngine on the serve_dynamic workload (16
    requests over 4 shared system prompts, chunks of 64, prefix cache on)
    and through the static engine on 8 of its requests.  (a) tokens and
    steps equal with the kernels and through the plain versions, on both
    engines (the serve phase's near-tie rule); (b) the dynamic engine's
    tokens equal with the prefix cache off; (c) a warm second serve shares
    more; (d) exact launch counts: B8 int8 30 per decode step, B9 int8 30
    per chunk forward, B1 61 per forward, no f32/bf16 B8/B9 and no B2-B7.
    Prints tok/s, the pools' MiB against f32 pools, and the top-1 agreement
    with the f32 dynamic engine on the same requests (``f32_dyn``: its
    tokens and tok/s in this run), which is printed, not held: at full width
    with random weights the f32 top-2 gaps are small.  The static engine's
    int8 tokens need not equal the dynamic engine's: a one-shot prefill
    attends in f32, a chunk forward over the int8 pages it has just
    written."""
    from repro_torch.serving.kv_cache import pool_bytes

    R, S, Pmax, Gmax, P, CH, R_STATIC = 16, 4, 256, 64, 16, 64, 8
    cfg8 = cfg.replace(kv_dtype="int8")
    prompts, lens = shared_prefix_workload(cfg.vocab_size, R, Pmax, seed=2)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    ecfg = EngineConfig(prefill_chunk=CH, prefix_cache=True, **kw)
    Rec = make_recording_model(Model)
    kern = Rec(cfg8, device="cuda", impl="auto")
    plain = Rec(cfg8, device="cuda", impl="ref")
    params = kern.init(seed=0)
    L = cfg.n_layers

    def expect(n_dec, n_chunk, n_fwd):
        return {"rmsnorm": (2 * L + 1) * n_fwd, "rmsnorm_bwd": 0, "ce_fwd": 0,
                "ce_bwd": 0, "flash_decode": 0, "flash_decode_multi": 0,
                "flash_decode_int8": L * n_dec, "flash_decode_multi_int8": L * n_chunk,
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_fwd_int8": 0, "flash_bwd_dq_int8": 0, "flash_bwd_dkv_int8": 0}

    # warm-up outside the counted runs
    DynamicEngine(kern, EngineConfig(prefill_chunk=CH, prefix_cache=True, n_slots=2,
                                     page_size=P, max_prompt_len=Pmax, max_gen_len=2)
                  ).serve(params, prompts[:1], lens[:1])
    kern.calls.clear()
    kern.n_decode = 0

    engine = DynamicEngine(kern, ecfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_chunk = sum(c["mode"] == "decode" and c["T"] > 1 for c in kern.calls)
    n_dec = sum(c["mode"] == "decode" and c["T"] == 1 for c in kern.calls)
    n_prefill = sum(c["mode"] == "prefill" for c in kern.calls)
    want = expect(n_dec, n_chunk, n_chunk + n_dec)
    log(f"[serve_int8] dynamic, kernels: {out_k['steps']} steps, {n_chunk} chunk "
        f"forwards, {n_dec} decode steps; launches {launches}, expected {want}")
    if launches != want or n_prefill:
        raise AssertionError(f"int8 dynamic launch counts {launches} != {want} "
                             f"({n_prefill} one-shot prefills)")

    # (a) the same serve through the plain versions.  The two paths' f32 k/v
    # differ by ulps (B1 sums in another order than its plain version), so
    # a value within an ulp of a half step rounds to the neighbouring byte
    # on one side: the pools' positions must be equal, their bytes differ
    # by at most one step where they differ, and the logits, which such a
    # byte moves by up to ~1e-1, are measured, not held at SERVE_LOGIT_TOL
    # (the kernels themselves are held at 2e-5 on the same bytes above)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine_r = DynamicEngine(plain, ecfg)
    out_r = engine_r.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"the plain serve launched kernels: {ops.launch_counts()}")
    tie_at, worst, scale = compare_calls("serve_int8", kern, plain, out_k, out_r,
                                         logit_tol=None)
    pools = pool_diff(engine._pools, engine_r._pools)
    log(f"[serve_int8] pools with the kernels against through the plain versions: "
        f"positions equal; {pools['bytes_differ']} of {pools['bytes']} int8 bytes "
        f"differ ({pools['bytes_differ'] / pools['bytes']:.2e}), by at most "
        f"{pools['max_byte_diff']} steps; scales max rel diff {pools['scale_rel']:.3g}")
    n_tok = int(out_k["lengths"].sum())
    cached = out_k["prefill_cached"]
    log(f"[serve_int8] (a) dynamic, kernels: {n_tok} tokens in {wall_k:.3f} s "
        f"({n_tok / wall_k:.1f} tok/s); plain: {int(out_r['lengths'].sum())} tokens in "
        f"{wall_r:.3f} s ({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s); greedy "
        f"tokens identical: {tie_at is None}; steps identical ({out_k['steps']}); first 8 "
        f"decode steps' logits max abs diff {worst:.3g} at |logit| <= {scale:.3g}; "
        f"{cached}/{out_k['prefill_total']} prompt tokens from shared pages")

    # (b) prefix cache off
    t0 = time.perf_counter()
    out_c = DynamicEngine(kern, EngineConfig(prefill_chunk=CH, **kw)).serve(
        params, prompts, lens)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    ties_b = greedy_agree("serve_int8 (b)", plain, params, prompts, lens, out_k, out_c)
    if not (cached > 0 and out_c["prefill_cached"] == 0):
        raise AssertionError(f"prefill_cached {cached} with the cache, "
                             f"{out_c['prefill_cached']} without")
    log(f"[serve_int8] (b) prefix cache off: {int(out_c['lengths'].sum())} tokens in "
        f"{wall_c:.3f} s ({int(out_c['lengths'].sum()) / wall_c:.1f} tok/s), "
        f"{out_c['steps']} steps; greedy tokens equal, {ties_b} requests past a tie")

    # (c) a warm second serve on the same engine
    t0 = time.perf_counter()
    out_w = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    ties_c = greedy_agree("serve_int8 (c)", plain, params, prompts, lens, out_k, out_w)
    if not out_w["prefill_cached"] > cached:
        raise AssertionError(f"warm int8 serve shared {out_w['prefill_cached']} prompt "
                             f"tokens, the cold one {cached}")
    engine.blocks.check_invariants()
    log(f"[serve_int8] (c) warm cache: {out_w['prefill_cached']}/"
        f"{out_w['prefill_total']} prompt tokens from shared pages (cold {cached}); "
        f"{int(out_w['lengths'].sum())} tokens in {wall_w:.3f} s, {out_w['steps']} "
        f"steps; greedy tokens equal, {ties_c} requests past a tie")

    # the static engine on the first R_STATIC requests, kernels and plain
    sp, sl = prompts[:R_STATIC], lens[:R_STATIC]
    kern.calls.clear()
    kern.n_decode = 0
    plain.calls.clear()
    plain.n_decode = 0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_s = Engine(kern, EngineConfig(**kw)).serve(params, sp, sl)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    static_launches = ops.launch_counts()
    steps_s = out_s["steps"]
    want_s = expect(steps_s, 0, steps_s + R_STATIC)
    log(f"[serve_int8] static, kernels: {steps_s} steps; launches {static_launches}, "
        f"expected {want_s}")
    if static_launches != want_s:
        raise AssertionError(f"int8 static launch counts {static_launches} != {want_s}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_sr = Engine(plain, EngineConfig(**kw)).serve(params, sp, sl)
    torch.cuda.synchronize()
    wall_sr = time.perf_counter() - t0
    tie_s, worst_s, scale_s = compare_calls("serve_int8 static", kern, plain, out_s,
                                            out_sr, logit_tol=None)
    n_tok_s = int(out_s["lengths"].sum())
    log(f"[serve_int8] (a) static, kernels: {n_tok_s} tokens in {wall_s:.3f} s "
        f"({n_tok_s / wall_s:.1f} tok/s); plain {wall_sr:.3f} s "
        f"({int(out_sr['lengths'].sum()) / wall_sr:.1f} tok/s); greedy tokens "
        f"identical: {tie_s is None}; steps identical ({steps_s}); first 8 decode steps' "
        f"logits max abs diff {worst_s:.3g} at |logit| <= {scale_s:.3g} (measured, not "
        f"held: see (a))")

    # what int8 buys and costs against the f32 dynamic engine in this run
    f32_tokens, f32_tok_per_s = f32_dyn
    mib8 = pool_bytes(cfg8, engine.spec) / 2**20
    mib32 = pool_bytes(cfg, engine.spec) / 2**20
    valid = torch.arange(Gmax)[None] < out_k["lengths"][:, None]
    agree = float((out_k["tokens"][valid] == f32_tokens[valid]).float().mean())
    log(f"[serve_int8] pools {mib8:.2f} MiB int8 against {mib32:.2f} MiB f32 "
        f"({mib32 / mib8:.2f}x); {n_tok / wall_k:.1f} tok/s against the f32 dynamic "
        f"engine's {f32_tok_per_s:.1f} in this run ({n_tok / wall_k / f32_tok_per_s:.1%});"
        f" greedy top-1 agreement with it {agree:.1%} (printed, not held)")
    return launches, static_launches, dict(
        requests=R, steps=out_k["steps"], chunk_forwards=n_chunk, decode_steps=n_dec,
        tokens=n_tok, wall_s=wall_k, tok_per_s=n_tok / wall_k, plain_wall_s=wall_r,
        plain_tok_per_s=int(out_r["lengths"].sum()) / wall_r,
        logit_max_abs_diff=worst, pools_vs_plain=pools,
        prefill_cached=cached, prefill_total=out_k["prefill_total"],
        warm_prefill_cached=out_w["prefill_cached"], warm_wall_s=wall_w,
        no_cache_wall_s=wall_c, no_cache_steps=out_c["steps"],
        ties=dict(b=ties_b, c=ties_c), pool_mib_int8=mib8, pool_mib_f32=mib32,
        f32_tok_per_s=f32_tok_per_s, top1_agreement_with_f32=agree,
        static=dict(requests=R_STATIC, steps=steps_s, tokens=n_tok_s, wall_s=wall_s,
                    tok_per_s=n_tok_s / wall_s, plain_wall_s=wall_sr),
    )


# the port's kernels, by the name of their __global__ function(s)
PORT_KERNELS = {
    "rmsnorm": ("rmsnorm_kernel<",),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernel<", "column_sum_kernel("),
    "ce_fwd": ("ce_fwd_kernel<",),
    "ce_bwd": ("ce_bwd_kernel<",),
    "flash_decode": ("flash_decode_kernel<",),
    "flash_decode_multi": ("flash_decode_multi_kernel<",),
    "flash_decode_int8": ("flash_decode_kernel<",),
    "flash_decode_multi_int8": ("flash_decode_multi_kernel<",),
    "flash_fwd": ("flash_fwd_kernel<",),
    "flash_bwd_dq": ("flash_bwd_dq_kernel<",),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel<",),
    "flash_fwd_int8": ("flash_fwd_i8_kernel<",),
    "flash_bwd_dq_int8": ("flash_bwd_dq_i8_kernel<",),
    "flash_bwd_dkv_int8": ("flash_bwd_dkv_i8_kernel<",),
}


# the int8-pool instantiations of B8 and B9 (TKV = int8_t) carry this in
# their demangled names; the B8/B9 rows named *_int8 are those, the others
# not (B5-B7's int8 mode has kernels of its own names)
INT8_KV = "signed char>"


def is_kernel(name, key, event_key):
    """Whether a profiler event named ``event_key`` is a launch of the port
    kernel ``name`` through its key ``key``."""
    if not name.startswith("flash_decode"):
        return key in event_key
    return key in event_key and (INT8_KV in event_key) == name.endswith("_int8")


def port_kernel_times(kernels):
    """{kernel: (device ms in total, launches)} of the port's kernels among
    the profiler's CUDA events."""
    out = {}
    for name, keys in PORT_KERNELS.items():
        parts = {k: [e for e in kernels if is_kernel(name, k, e.key)] for k in keys}
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



@contextlib.contextmanager
def labelled(module, names):
    """While open, the functions ``names`` of ``module`` run inside a
    torch.profiler range of the same name (for the kernels they launch)."""
    from torch.profiler import record_function

    real = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def run(*a, **kw):
            with record_function(n):
                return fn(*a, **kw)
        return run

    for n, fn in real.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def profile_phase(cfg, Model, Engine, EngineConfig, dynamic=None, ranges=()):
    """Where a decode-heavy serve spends the card's time: torch.profiler over
    a short serve (4 requests x 16 tokens), device busy share and the
    kernels that take it.  ``dynamic`` = (DynamicEngine, prefill_chunk):
    the dynamic engine with chunked prefill and the prefix cache over 4
    requests that share a 128-token system prompt.  ``ranges``: functions
    of serving/kv_cache.py whose launches are summed under their own name
    (the int8 pools' quantized writes).  The profiler's own overhead
    inflates the wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import kv_cache

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))
    lens = np.full(4, 128)
    kw = dict(n_slots=4, page_size=16, max_prompt_len=128, max_gen_len=16)
    if dynamic is None:
        make = lambda: Engine(model, EngineConfig(**kw))
    else:
        cls, chunk = dynamic
        prompts = np.concatenate([np.repeat(prompts[:1, :96], 4, 0), prompts[:, 96:]], 1)
        make = lambda: cls(model, EngineConfig(prefill_chunk=chunk, prefix_cache=True, **kw))
    make().serve(params, prompts, lens)          # warm-up
    engine = make()
    torch.cuda.synchronize()
    with labelled(kv_cache, ranges), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = engine.serve(params, prompts, lens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    # a labelled range also shows on the device as an annotation spanning its
    # first to its last kernel, gaps included: not a kernel, left out
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    tag = "" if dynamic is None else " (dynamic engine)"
    tag += f" ({cfg.kv_dtype} pools)" if cfg.kv_dtype else ""
    log(f"[profile] {out['steps']} steps{tag} in {wall_us / 1e3:.1f} ms under the "
        f"profiler; device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    extra = {} if dynamic is None else dict(prefill_cached=out["prefill_cached"],
                                            prefill_total=out["prefill_total"])
    for name in ranges:
        # the kernels launched by the range's ops (its own annotation aside)
        hits = [e for e in prof.events() if e.name == name and e.device_type != cuda]
        dev_ms = sum(c.device_time_total for e in hits for c in e.cpu_children) / 1e3
        calls = len(hits)
        host_ms = sum(e.cpu_time_total for e in hits) / 1e3
        log(f"[profile]   {name}: {calls} calls, {dev_ms:.3f} ms on the card "
            f"({dev_ms / max(busy_us / 1e3, 1e-9):.1%} of busy), {host_ms:.1f} ms "
            f"on the host under the profiler")
        extra[name] = dict(calls=calls, device_ms=dev_ms, host_ms=host_ms)
    return dict(steps=out["steps"], wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                launches=sum(e.count for e in kernels),
                port_kernels=port_kernel_times(kernels), **extra)



# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def models_attend_with(ops, attention):
    """While open, models call ``attention`` where they call ops.attention
    (None leaves it as it is)."""
    real = ops.attention
    if attention is not None:
        ops.attention = attention
    yield
    ops.attention = real


def plain_flash(ops):
    """Attention's kernel path over B5-B7's plain versions, which round where
    the kernels round (ops.attention_plain_flash); launches nothing."""
    return lambda q, k, v, *, impl="auto", **kw: ops.attention_plain_flash(q, k, v, **kw)


def mode_kernels(ops, policy):
    """B5-B7 in ``policy``'s operand mode whatever the model's: a control."""
    real = ops.attention
    return lambda q, k, v, *, impl="auto", policy=None, _p=policy, **kw: real(
        q, k, v, impl="kernel", policy=_p, **kw)


def max_rel(a, b):
    """max |a - b| / max |b| (0 for an all-zero b that a matches)."""
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    return err / scale if scale else err


def train_phase(ops, quant, amp="", control_losses=None):
    """mup-gpt at full width (``amp`` its mixed-precision policy, as
    ``--amp`` sets it): the first step's loss and gradients with and without
    the kernels, then 10 train_loop steps each way from the same init and
    batches; launch counts of the kernel run, peak memory of both.

    Under amp the plain side's attention rounds (bf16) or quantizes (int8)
    where the kernels do (plain_flash): the policy's own plain attention
    rounds or quantizes the normalized p over whole rows and forms delta
    from the rounded do and v, which moves the numbers about as far as the
    policy itself (its distance is printed, not held).  The loss limits
    (AMP_LIMITS) must reject a control: attention's kernels in another
    operand mode on the first step (f32 for bf16, bf16 for int8),
    ``control_losses`` (the f32 phase's) at step 0 of the loop.  A third
    loop, through the policy's plain attention, gives the plain time and
    peak memory; the gap of its last losses to the f32 run's is printed."""
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import HParams, transfer
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import Model
    from repro_torch.optim.grad import value_and_grad

    B, S, STEPS = 8, 512, 10
    cfg = get_config("mup-gpt").replace(dtype="float32", amp=amp)
    tag = f"[train {amp}]" if amp else "[train]"
    if amp:
        loss_rtol, grad_tol, loop_rtol, control_mode = AMP_LIMITS[amp]
    else:
        loss_rtol = loop_rtol = TRAIN_LOSS_RTOL
    hps = HParams()
    # the first-step check starts from a random query projection, so that
    # attention is not uniform (zero-init q makes it so at step 0)
    model_cfg = cfg.replace(**transfer(hps, cfg)["model"], zero_init_query=False)
    kern = Model(model_cfg, device="cuda", impl="auto")
    plain = Model(model_cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    batch0 = {k: torch.from_numpy(v).cuda() for k, v in
              make_pipeline(cfg.vocab_size, S, B, seed=0).batch(0).items()}
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f}M params; batch {B} x seq {S}, f32"
        + (f", --amp {amp}" if amp else ""))

    loss_k, grads_k = value_and_grad(kern.loss_fn, params, batch0)
    # under amp the first step isolates B5-B7: B1-B4 run on both sides, so
    # that attention's inputs are the same bits
    with models_attend_with(ops, plain_flash(ops) if amp else None):
        loss_p, grads_p = value_and_grad((kern if amp else plain).loss_fn, params, batch0)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel = {n: max_rel(grads_k[n], grads_p[n]) for n in grads_p}
    if amp:
        # the controls: attention's kernels in another operand mode and, under
        # int8, its plain versions tiled 64 wide (scales over other tiles)
        from repro_torch.kernels import ref

        other = quant.QuantPolicy(control_mode)
        controls = {f"attention's kernels in the {control_mode} operand mode":
                    (contextlib.nullcontext(),
                     mode_kernels(ops, other if other.active else None))}
        if amp == "int8":
            controls["the plain versions tiled 64 wide"] = (int8_tiles(ref, 64),
                                                            plain_flash(ops))
        ctrl = {}
        for what, (tiles, attention) in controls.items():
            with tiles, models_attend_with(ops, attention):
                loss_c, grads_c = value_and_grad(kern.loss_fn, params, batch0)
            ctrl[what] = (abs(float(loss_c) - float(loss_p)) / abs(float(loss_p)),
                          {n: max_rel(grads_c[n], grads_p[n]) for n in grads_p})
            del grads_c
        loss_q, grads_q = value_and_grad(plain.loss_fn, params, batch0)
        rel_q = abs(float(loss_k) - float(loss_q)) / abs(float(loss_q))
        policy_rel = {n: max_rel(grads_k[n], grads_q[n]) for n in grads_q}
        del grads_q
        log(f"{tag} first step, max abs err over each tensor's largest plain entry: "
            f"kernels loss rel {rel:.3g}, "
            + ", ".join(f"{n} {e:.2g}" for n, e in grad_rel.items())
            + "".join(f"; control, {what}: loss rel {c[0]:.3g}, "
                      + ", ".join(f"{n} {e:.2g}" for n, e in c[1].items())
                      for what, c in ctrl.items())
            + f"; kernels against the policy's plain attention (not held): loss "
            f"rel {rel_q:.3g}, " + ", ".join(f"{n} {e:.2g}" for n, e in policy_rel.items()))
        for what, (rel_c, _) in ctrl.items():
            if not rel_c > loss_rtol:
                raise AssertionError(f"the control, {what}, passes the loss limit: "
                                     f"rel {rel_c}")
        bad = {n: e for n, e in grad_rel.items() if not e <= grad_tol}
    else:
        for n in grads_p:
            check_close(f"first-step grad {n}", grads_k[n], grads_p[n],
                        *GRAD_TOL[torch.float32])
        bad = {}
    if not rel <= loss_rtol or bad:
        raise AssertionError(f"first step: loss {float(loss_k)} vs plain {float(loss_p)} "
                             f"(rel {rel}); gradients beyond the limit: {bad}")
    grad_err = {n: (grads_k[n] - grads_p[n]).abs().max().item() for n in grads_p}
    log(f"{tag} first step: loss {float(loss_k):.6f} vs plain {float(loss_p):.6f} "
        f"(rel {rel:.3g}); gradients agree, max abs err per tensor "
        + ", ".join(f"{n} {e:.2g}" for n, e in grad_err.items()))
    first = dict(first_step_loss_rel_diff=rel, first_step_grad_max_abs_err=grad_err,
                 first_step_grad_rel_err=grad_rel)
    if amp:
        first.update(controls={what: dict(loss_rel_diff=c[0], grad_rel_err=c[1])
                               for what, c in ctrl.items()},
                     policy_plain_loss_rel_diff=rel_q, policy_plain_grad_rel_err=policy_rel)
    # the loops make their own weights: nothing of this step stays on the card
    del grads_k, grads_p, params, batch0

    def loop(impl, log_every=0):
        """The run's losses and step times (its weights are dropped, so that
        they do not count in the next run's peak memory) and peak GiB."""
        torch.cuda.reset_peak_memory_stats()
        out = train_loop(cfg, STEPS, hps, batch_size=B, seq_len=S, seed=0,
                         log_every=log_every, device="cuda", impl=impl)
        torch.cuda.synchronize()
        keep = ("losses", "step_seconds", "batch_seconds")
        return {k: out[k] for k in keep}, torch.cuda.max_memory_allocated() / 2**30

    ops.reset_launch_counts()
    out_k, peak_gib = loop("auto", log_every=1)
    launches = ops.launch_counts()
    n_attn = cfg.n_layers if amp == "bf16" else 0   # B5-B7 only under --amp,
    n_int8 = cfg.n_layers if amp == "int8" else 0   # in its operand mode
    per_step = {"rmsnorm": 2 * cfg.n_layers + 1, "rmsnorm_bwd": 2 * cfg.n_layers + 1,
                "ce_fwd": 1, "ce_bwd": 1, "flash_decode": 0,
                "flash_decode_multi": 0, "flash_decode_int8": 0,
                "flash_decode_multi_int8": 0, "flash_fwd": n_attn,
                "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn,
                "flash_fwd_int8": n_int8, "flash_bwd_dq_int8": n_int8,
                "flash_bwd_dkv_int8": n_int8}
    want = {k: v * STEPS for k, v in per_step.items()}
    log(f"{tag} kernels: launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")

    ops.reset_launch_counts()
    with models_attend_with(ops, plain_flash(ops) if amp else None):
        out_p, peak_p = loop("ref")
    out_y, plain_peak_gib = loop("ref") if amp else (out_p, peak_p)
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"plain runs launched kernels: {ops.launch_counts()}")

    lk, lp, ly = out_k["losses"], out_p["losses"], out_y["losses"]
    if not all(np.isfinite(lk + lp + ly)):
        raise AssertionError(f"non-finite losses: {lk} / {lp} / {ly}")
    if not (lk[-1] < lk[0] and lp[-1] < lp[0] and ly[-1] < ly[0]):
        raise AssertionError(f"loss did not fall: {lk} / {lp} / {ly}")
    rel0 = abs(lk[0] - lp[0]) / abs(lp[0])
    if not rel0 <= loop_rtol:
        raise AssertionError(f"step-0 loss {lk[0]} vs plain {lp[0]} (rel {rel0})")
    rel_all = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    extra = {}
    if amp:
        ctrl0 = abs(control_losses[0] - lp[0]) / abs(lp[0])
        if not ctrl0 > loop_rtol:
            raise AssertionError(f"the f32 run's step-0 loss {control_losses[0]} passes "
                                 f"the amp loop's limit (rel {ctrl0})")
        # the reference's amp bar (tests/test_quant.py): the mean of the last 3
        # losses against the f32 run's; printed, not held on the card
        f32_last = float(np.mean(control_losses[-3:]))
        extra = dict(control_step0_rel_diff=ctrl0, policy_plain_losses=ly,
                     policy_plain_step0_rel_diff=abs(lk[0] - ly[0]) / abs(ly[0]),
                     last3_gap_to_f32=(float(np.mean(lk[-3:])) - f32_last) / f32_last)
    # steady state: the first step builds cuBLAS handles and the allocator
    ms_k = 1e3 * float(np.median(out_k["step_seconds"][1:]))
    ms_p = 1e3 * float(np.median(out_y["step_seconds"][1:]))
    # the part of a step spent making the batch on the host and copying it
    batch_k = 1e3 * float(np.median(out_k["batch_seconds"][1:]))
    batch_p = 1e3 * float(np.median(out_y["batch_seconds"][1:]))
    log(f"{tag} losses with kernels {[round(v, 4) for v in lk]}")
    log(f"{tag} losses plain        {[round(v, 4) for v in lp]}")
    if amp:
        log(f"{tag} losses through the policy's plain attention {[round(v, 4) for v in ly]}"
            f"; step 0 of the f32 run {control_losses[0]:.4f} (rel "
            f"{extra['control_step0_rel_diff']:.3g} from the plain amp run); mean of the "
            f"last 3 losses {extra['last3_gap_to_f32']:+.3%} from the f32 run's (not held)")
    log(f"{tag} step-0 loss rel diff {rel0:.3g}, max over steps {rel_all:.3g}; "
        f"ms/step (median of steps 1-{STEPS - 1}, batch generation included) "
        f"kernels {ms_k:.2f} ({B * S / ms_k * 1e3:.0f} tok/s, of which batch "
        f"{batch_k:.2f} ms), plain {ms_p:.2f} ({B * S / ms_p * 1e3:.0f} tok/s, "
        f"batch {batch_p:.2f} ms); peak memory {peak_gib:.2f} GiB with the "
        f"kernels, {plain_peak_gib:.2f} GiB plain")
    return launches, dict(
        steps=STEPS, batch=B, seq=S, tokens_per_step=B * S,
        losses=lk, plain_losses=lp, step0_rel_diff=rel0, max_rel_diff=rel_all,
        ms_per_step=ms_k, plain_ms_per_step=ms_p,
        batch_ms=batch_k, plain_batch_ms=batch_p,
        tok_per_s=B * S / ms_k * 1e3, plain_tok_per_s=B * S / ms_p * 1e3,
        step_seconds=out_k["step_seconds"], plain_step_seconds=out_y["step_seconds"],
        batch_seconds=out_k["batch_seconds"],
        peak_memory_gib=peak_gib, plain_peak_memory_gib=plain_peak_gib,
        **first, **extra,
    )


def train_profile_phase(amp=""):
    """torch.profiler over one steady train step (after a warm-up step),
    ``amp`` the mixed-precision policy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.optim.schedules import linear_decay

    cfg = get_config("mup-gpt").replace(dtype="float32", amp=amp)
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
    log(f"[profile] one train step{' --amp ' + amp if amp else ''}: "
        f"{wall_us / 1e3:.1f} ms under the profiler; "
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
    from repro_torch import quant
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig

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

    def done(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t0:.0f} s")

    torch.manual_seed(0)
    rows = [rmsnorm_phase(ops, rn, F), rmsnorm_bwd_phase(rn, ref, F),
            *ce_phase(ce, ref, F)]
    done("B1-B4 kernel phases")
    rows += flash_phase(ops, fa, ref, quant, F)
    done("B5-B7 kernel phase")
    rows.append(decode_phase(ops, da, F))
    rows.append(multi_phase(ops, da, F))
    rows.append(int8_decode_phase(ops, F))
    rows.append(int8_multi_phase(ops, F))
    done("B8-B9 kernel phases (f32/bf16 and int8 pools)")
    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False)
    serve_launches, serve = serve_phase(cfg, Model, Engine, EngineConfig, ops)
    done("serve")
    dyn_launches, dyn_tokens, dyn = dynamic_serve_phase(cfg, Model, Engine, DynamicEngine,
                                                        EngineConfig, ops)
    done("serve_dynamic")
    int8_launches, int8_static_launches, srv8 = serve_int8_phase(
        cfg, Model, Engine, DynamicEngine, EngineConfig, ops,
        (dyn_tokens, dyn["tok_per_s"]))
    done("serve_int8")
    train_launches, train = train_phase(ops, quant)
    done("train")
    amp_launches, amp = train_phase(ops, quant, amp="bf16", control_losses=train["losses"])
    done("train --amp bf16")
    amp8_launches, amp8 = train_phase(ops, quant, amp="int8", control_losses=train["losses"])
    done("train --amp int8")
    serve["profile"] = profile_phase(cfg, Model, Engine, EngineConfig)
    dyn["profile"] = profile_phase(cfg, Model, Engine, EngineConfig,
                                   dynamic=(DynamicEngine, 64))
    srv8["profile"] = profile_phase(cfg.replace(kv_dtype="int8"), Model, Engine,
                                    EngineConfig, dynamic=(DynamicEngine, 64),
                                    ranges=("_quantized_write",))
    train["profile"] = train_profile_phase()
    amp["profile"] = train_profile_phase(amp="bf16")
    amp8["profile"] = train_profile_phase(amp="int8")
    done("profiles")
    for row in rows:
        by_path = {"serve": serve_launches[row["name"]],
                   "serve_dynamic": dyn_launches[row["name"]],
                   "serve_int8": int8_launches[row["name"]],
                   "serve_int8_static": int8_static_launches[row["name"]],
                   "train": train_launches[row["name"]],
                   "train_amp_bf16": amp_launches[row["name"]],
                   "train_amp_int8": amp8_launches[row["name"]]}
        if not sum(by_path.values()):
            raise AssertionError(f"{row['name']} was launched on no main path")
        only = {"flash_decode_multi": ("serve_dynamic",),
                "flash_decode_int8": ("serve_int8", "serve_int8_static"),
                "flash_decode_multi_int8": ("serve_int8",),
                "flash_fwd_int8": ("train_amp_int8",),
                "flash_bwd_dq_int8": ("train_amp_int8",),
                "flash_bwd_dkv_int8": ("train_amp_int8",)}.get(row["name"])
        if only and sum(by_path.values()) != sum(by_path[p] for p in only):
            raise AssertionError(f"{row['name']} launched off the {only} paths: {by_path}")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        log(json.dumps(row))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"serve_dynamic": dyn}))
    log(json.dumps({"serve_int8": srv8}))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_amp_bf16": amp}))
    log(json.dumps({"train_amp_int8": amp8}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
