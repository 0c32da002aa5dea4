#!/usr/bin/env python3
"""Host cost of one layer's paged KV cache write, int8 against float32 pools.

    python3 scripts/torch_kv_write_probe.py

On the GPU, for smollm-135m's pool geometry (3 kv heads of 64, pages of 16)
and a decode step's write (4 slots, one token each), prints per pool type:
whether the write synchronizes with the host (``torch.cuda.
set_sync_debug_mode``, which PyTorch calls a prototype that may miss some
syncs), the host clock per call over 1, 10 and 200 calls (enqueue, and up
to a synchronize), the kernel launches per call and the card's time per
call (torch.profiler over 20 calls).  The write is ``serving/kv_cache.py``'s
``paged_cache_write`` with the kept cells found once, as a forward does.
"""
from __future__ import annotations

import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kv_write_probe: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serving import kv_cache as kv

    cfg = get_config("smollm-135m").replace(dtype="float32")
    spec = kv.build_spec(cfg, 4, 320, 16)
    for name, c in (("int8", cfg.replace(kv_dtype="int8")), ("float32", cfg)):
        pools = kv.init_pools(c, spec, "cuda")["groups"]["0_attn"]["attn"]
        layer = {n: t[0] for n, t in pools.items()}
        tab = torch.arange(4 * spec.gp_cols, dtype=torch.int32, device="cuda").reshape(4, -1)
        k = torch.randn(4, 1, cfg.n_kv_heads, cfg.d_head, device="cuda")
        v = torch.randn_like(k)
        pos = torch.full((4, 1), 100, dtype=torch.int32, device="cuda")
        active = torch.ones(4, dtype=torch.bool, device="cuda")
        slots = kv.write_slots(pos, tab, active, spec.page_size)

        def write():
            kv.paged_cache_write(layer, k, v, pos, tab, active, spec.page_size, slots=slots)

        for _ in range(20):
            write()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            write()
        torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in seen if "synchroniz" in str(w.message).lower()
                 and "prototype" not in str(w.message)]
        print(f"[probe] {name}: syncs seen {len(syncs)} {syncs[:2]}")
        for n in (1, 10, 200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                write()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"[probe] {name} x{n}: host {(t1 - t0) / n * 1e3:.4f} ms a call to "
                  f"enqueue, {(t2 - t0) / n * 1e3:.4f} ms to the synchronize")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                write()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e for e in prof.key_averages() if e.device_type == cuda]
        launches = sum(e.count for e in kernels) / 20
        dev_us = sum(e.self_device_time_total for e in kernels) / 20
        print(f"[probe] {name}: {launches:.0f} kernel launches a call, {dev_us:.1f} us "
              f"on the card a call")


if __name__ == "__main__":
    main()
