#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then serves
smollm-135m at its published full width through the static engine (random
weights from a seed, ``zero_init_query=False`` so attention is not uniform),
once through the kernels and once through the plain versions, and checks
that both give the same greedy tokens.  It needs one card, imports nothing
of JAX or of the reference package, catches no failure (any failed check
raises, so the exit code is non-zero) and prints, last, one JSON line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

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
    n0 = rn.launches
    ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="kernel"))
    rn.launches = n0     # timing launches are not main-path launches
    plain_ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="ref"))
    w = (1 + g).to(x.dtype)
    library_ms = cuda_ms(lambda: F.rms_norm(x, (576,), weight=w, eps=1e-6))
    nbytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())

    # the prefill shape of the same path: one 256-token prompt
    xp = torch.randn(1, 256, 576, device="cuda")
    n0 = rn.launches
    pre_ms = cuda_ms(lambda: ops.fused_rmsnorm(xp, g, impl="kernel"))
    rn.launches = n0
    pre_plain = cuda_ms(lambda: ops.fused_rmsnorm(xp, g, impl="ref"))
    pre_lib = cuda_ms(lambda: F.rms_norm(xp, (576,), weight=w, eps=1e-6))
    pre_bound, _ = bound(2 * xp.numel() * 4 + 576 * 4, 4 * xp.numel())
    log(f"[kernels] rmsnorm x (1, 256, 576) f32: {pre_ms:.5f} ms, plain "
        f"{pre_plain:.5f} ms, F.rms_norm {pre_lib:.5f} ms, bound {pre_bound:.6f} ms")
    return dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:28",
        shape="x (4, 1, 576) float32 (decode step)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="torch.nn.functional.rms_norm(weight=1+g)",
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
    n0 = da.launches
    ms = cuda_ms(lambda: ops.decode_attention(*args, scale=0.125, impl="kernel"))
    da.launches = n0
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


def serve_phase(cfg_f32, Model, Engine, EngineConfig, rn, da):
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
    rn.launches = da.launches = 0
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = {"rmsnorm": rn.launches, "flash_decode": da.launches}
    steps = out_k["steps"]
    # one decode attention per layer per step; two norms per layer plus the
    # final norm per forward (a decode step or an admission's prefill)
    L = cfg_f32.n_layers
    want = {"flash_decode": L * steps, "rmsnorm": (2 * L + 1) * (steps + R)}
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
                launches=sum(e.count for e in kernels))


# ---------------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
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
    rows = [rmsnorm_phase(ops, rn, F), decode_phase(ops, da, F)]
    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False)
    launches, serve = serve_phase(cfg, Model, Engine, EngineConfig, rn, da)
    serve["profile"] = profile_phase(cfg, Model, Engine, EngineConfig)
    for row in rows:
        row["launches"] = launches[row["name"]]
        log(json.dumps(row))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
