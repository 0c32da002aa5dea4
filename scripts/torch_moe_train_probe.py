#!/usr/bin/env python3
"""Where a mixtral-8x22b train step's time goes on the card.

    python3 scripts/torch_moe_train_probe.py [--amp "" bf16 int8]

mixtral-8x22b at full width over 1 of its 56 layers (as ``chip_smoke.py``'s
``train_mixtral`` phases train it: one sequence of 4,608 tokens, f32
weights from seed 0 with a random readout and query projection, AdamW at
lr 1e-4), one train step of ``launch/steps.py`` after a warm-up step, for
each ``--amp`` mode:

- the host time of the synthetic batch (``data/pipeline.py``, 4,608 draws
  over vocab 32,768) and of the step to its loss read back;
- CUDA events around the step's parts, each synchronised: forward and
  loss, backward, the global-norm clip, the AdamW update, applying the
  updates;
- torch.profiler over one step: the card's busy share and its time by
  kind of kernel (GEMMs, the port's kernels, elementwise and reductions,
  index and copy), the top kernels;
- the peak device memory of the step.

Prints one line per measurement and a last JSON line with every number;
the card's name and power limit first.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

KINDS = (("gemm", ("gemm", "sgemm", "cutlass", "xmma", "dgemm", "gemv", "splitk")),
         ("port kernels", ("rmsnorm", "ce_fwd", "ce_bwd", "flash_")),
         ("index and copy", ("index", "scatter", "gather", "copy", "cat", "embedding",
                             "sort", "radix")),
         ("elementwise and reductions", ()))


def kind_of(name):
    low = name.lower()
    return next(k for k, keys in KINDS if any(s in low for s in keys) or not keys)


def step_parts(model, opt, params, state, batch):
    """CUDA-event ms of the step's parts, each synchronised, and the step's
    outputs (the parts are launch/steps.py's train step, spelled out)."""
    from repro_torch.optim.grad import clip_by_global_norm
    from repro_torch.optim.optimizer import apply_updates

    ms, out = {}, {}

    def part(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        r = fn()
        b.record()
        torch.cuda.synchronize()
        ms[name] = a.elapsed_time(b)
        return r

    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = part("forward and loss", lambda: model.loss_fn(leaves, batch))
    grads = part("backward", lambda: dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values())))))
    del leaves
    grads, gnorm = part("clip", lambda: clip_by_global_norm(grads, 1.0))
    updates, state = part("adamw update", lambda: opt.update(grads, state, params))
    del grads
    params = part("apply updates", lambda: apply_updates(params, updates))
    out.update(loss=float(loss), grad_norm=float(gnorm))
    return ms, out, params, state


def probe(amp):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.optim.schedules import linear_decay

    cfg = get_config("mixtral-8x22b").replace(
        n_layers=1, dtype="float32", amp=amp, zero_init_query=False, zero_init_readout=False)
    model = Model(cfg, device="cuda")
    opt = Optimizer.create("adamw", 1e-4, model.p13n, model.meta, schedule=linear_decay(10))
    step = make_train_step(model, opt)
    params = model.init(seed=0)
    state = opt.init(params)
    pipe = make_pipeline(cfg.vocab_size, 4608, 1, seed=0)
    t0 = time.perf_counter()
    host = pipe.batch(0)
    batch_ms = (time.perf_counter() - t0) * 1e3
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    params, state, _ = step(params, state, batch)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, metrics = step(params, state, batch)
    float(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    ms, _, params, state = step_parts(model, opt, params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kind = {}
    for e in kernels:
        k = kind_of(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    tag = f"[moe_train --amp {amp}]" if amp else "[moe_train]"
    print(f"{tag} host batch {batch_ms:.1f} ms; a step to its loss read back {step_ms:.1f} ms "
          f"(batch made beforehand); parts (CUDA events, each synchronised) "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()), flush=True)
    print(f"{tag} one step under the profiler {wall_ms:.1f} ms, card busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in kernels)} launches; by kind "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(by_kind.items(), key=lambda x: -x[1]))
          + f"; peak memory {peak_gib:.2f} GiB", flush=True)
    for e in top:
        print(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}",
              flush=True)
    del params, state
    torch.cuda.empty_cache()
    return dict(amp=amp, batch_ms=batch_ms, step_ms=step_ms, parts_ms=ms, wall_ms=wall_ms,
                busy_ms=busy_ms, busy_share=busy_ms / wall_ms, by_kind_ms=by_kind,
                peak_gib=peak_gib,
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--amp", nargs="*", default=["", "bf16", "int8"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_moe_train_probe: needs a CUDA device")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    build.wait()
    print(json.dumps({"moe_train_probe": [probe(a) for a in args.amp]}))


if __name__ == "__main__":
    main()
