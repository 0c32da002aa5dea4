#!/usr/bin/env python3
"""Where the host time of one B1 (fused RMSNorm) call goes, on the GPU.

    python3 scripts/torch_rmsnorm_host_probe.py [--src DIR] [--n N]

Imports the port from ``DIR`` (default: this checkout's ``src``), so that
an older tree unpacked beside it can be timed by the same script in the
same call.  Prints the card's name and power limit, then, at the serve
path's decode shape x (4, 1, 576) f32, the host microseconds a call of
each step of B1's call path (``time.perf_counter_ns`` over N calls after a
warm-up: the median of 5 rounds, each of which times every step in turn,
the card synchronised between them, outside the timed loops): the
dispatch (``ops.resolve_impl``, ``x.contiguous()``), the gain's
conversion, the wrapper's checks (``rmsnorm._check``), the output's
allocation, ``build.library()``, the stream handle (as a
``torch.cuda.Stream`` and raw), the C entry point through ctypes (which
launches the kernel), ``build.check``, the wrapper ``rmsnorm.rmsnorm``,
the autograd Function ``ops._RMSNorm.apply``, the whole
``ops.fused_rmsnorm`` call with and without a gradient wanted, and
``F.rms_norm`` as the yardstick; then the whole call and ``F.rms_norm``
at the train shape x (8, 512, 1024), and each whole call's CUDA-event
time as ``chip_smoke.py`` takes it.  Steps that a tree does not have are
skipped.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def log(*a):
    print(*a, flush=True)


def host_us(fns, n, rounds=5):
    """{name: host microseconds a call} of each function in ``fns``: the
    median over ``rounds`` rounds, each of which times every function over
    n / rounds calls in turn (so that the host's drift reaches all alike),
    the card synchronised between them (not timed)."""
    for fn in fns.values():
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    per = {name: [] for name in fns}
    m = max(1, n // rounds)
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter_ns()
            for _ in range(m):
                fn()
            per[name].append((time.perf_counter_ns() - t0) / m / 1e3)
            torch.cuda.synchronize()
    return {name: sorted(v)[len(v) // 2] for name, v in per.items()}


def event_us(fn, n=200):
    """Microseconds a call on the card's clock (CUDA events around n calls,
    as chip_smoke.py's cuda_ms)."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--n", type=int, default=10_000)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_rmsnorm_host_probe: needs a CUDA device")
    sys.path.insert(0, a.src)
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops
    from repro_torch.kernels import rmsnorm as rn

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60).stdout.strip())
    log(f"[host] tree {a.src}, torch {torch.__version__}, {a.n} calls a step")
    x = torch.randn(4, 1, 576, device="cuda")
    g = 0.5 * torch.randn(576, device="cuda")
    w = 1 + g
    y = torch.empty_like(x)
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), g.data_ptr(), y.data_ptr(), 4, 576, 1e-6, 0, stream)
    xg = x.clone().requires_grad_(True)
    steps = [
        ("ops.resolve_impl", lambda: ops.resolve_impl("kernel", x)),
        ("x.contiguous()", lambda: x.contiguous()),
        ("gain.float().contiguous()", lambda: g.float().contiguous()),
        ("rmsnorm._check", lambda: rn._check(x, g, "rmsnorm")),
        ("torch.empty_like", lambda: torch.empty_like(x)),
        ("build.library()", build.library),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        ("torch._C._cuda_getCurrentRawStream", lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("C entry point by ctypes (launches)", lambda: lib.repro_rmsnorm(*args)),
        ("build.check(0)", lambda: build.check(0, "rmsnorm kernel")),
        ("rmsnorm.rmsnorm (the wrapper)", lambda: rn.rmsnorm(x, g)),
        ("ops._RMSNorm.apply (no grad wanted)", lambda: ops._RMSNorm.apply(x, g, 1e-6, True)),
        ("ops.fused_rmsnorm (no grad wanted)", lambda: ops.fused_rmsnorm(x, g, impl="kernel")),
        ("ops.fused_rmsnorm (x requires grad)", lambda: ops.fused_rmsnorm(xg, g, impl="kernel")),
        ("F.rms_norm", lambda: F.rms_norm(x, (576,), weight=w, eps=1e-6)),
    ]
    have = {}
    for name, fn in steps:
        try:
            fn()
        except (AttributeError, TypeError) as e:   # a step this tree does not have
            log(f"[host] x (4, 1, 576) f32: {name}: not in this tree ({e})")
            continue
        have[name] = fn
    for name, us in host_us(have, a.n).items():
        log(f"[host] x (4, 1, 576) f32: {name}: {us:.3f} us a call")
    xt = torch.randn(8, 512, 1024, device="cuda")
    gt = 0.5 * torch.randn(1024, device="cuda")
    wt = 1 + gt
    for label, xx, gg, ww in (("x (4, 1, 576)", x, g, w), ("x (8, 512, 1024)", xt, gt, wt)):
        D = xx.shape[-1]
        call = event_us(lambda: ops.fused_rmsnorm(xx, gg, impl="kernel"))
        lib_call = event_us(lambda: F.rms_norm(xx, (D,), weight=ww, eps=1e-6))
        host = host_us({"call": lambda: ops.fused_rmsnorm(xx, gg, impl="kernel"),
                        "lib": lambda: F.rms_norm(xx, (D,), weight=ww, eps=1e-6)}, 2000)
        log(f"[host] {label} f32 on the card's clock: ops.fused_rmsnorm {call:.3f} us a call, "
            f"F.rms_norm {lib_call:.3f} us a call ({call / lib_call:.2f}x); on the host's "
            f"clock {host['call']:.3f} and {host['lib']:.3f} us a call")


if __name__ == "__main__":
    main()
