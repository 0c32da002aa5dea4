"""Training entry point: the port's counterpart of ``python -m repro.launch.train``.

On the card by default (``--device cpu`` for the CPU):
  - muP-parametrized model + muP AdamW with per-tensor LRs, the loss through
    the chunked cross-entropy kernels and every RMSNorm forward and backward
    through its kernel,
  - ``--amp bf16`` / ``--amp int8``: the mixed-precision policy; attention
    forward and backward through the flash-attention kernels with bf16 (or
    per-tile scaled int8) tile-matmul operands, the readout logit matmul
    under the same policy (master weights and optimizer state stay f32),
  - deterministic stateless-resumable synthetic data (the reference's
    batches, bit for bit),
  - step-atomic checkpoints with async writes,
  - checkpoint/restart fault tolerance: ``--simulate-failure N`` raises at
    step N, then main() restarts the loop in-process and resumes from the
    last committed checkpoint,
  - per-step wall-clock watchdog (straggler detection),
  - optional bf16 gradient compression and microbatch accumulation.

  - observability: ``--telemetry`` builds the step with the µP-health
    statistics (obs/telemetry.py: activation coordinate sizes and
    update-to-weight ratios, drained into a ring once a step in one
    device-to-host copy); ``--obs-dir DIR`` records the step metrics and a
    ``train_step`` span a step and writes ``DIR/metrics.prom`` (Prometheus
    text), ``DIR/metrics.json`` (the registry's snapshot), ``DIR/trace.jsonl``
    (the spans) and, with ``--telemetry``, ``DIR/telemetry.jsonl`` (one
    health record a step).

Flags of parts not ported yet (``--model-parallel`` above 1, ``--fsdp``)
exit with an error naming the slice that brings them.

Usage:
    python -m repro_torch.launch.train --arch mup-gpt --steps 20 --seq-len 512
    python -m repro_torch.launch.train --arch mup-gpt --amp bf16 --steps 20 --seq-len 512
    python -m repro_torch.launch.train --arch mup-gpt --amp int8 --steps 20 --seq-len 512
    python -m repro_torch.launch.train --arch mup-gpt --smoke --steps 20 --device cpu
    python -m repro_torch.launch.train --arch mup-gpt --smoke --steps 20 --device cpu \
        --telemetry --obs-dir /tmp/obs
    python -m repro_torch.launch.train --arch mixtral-8x22b --smoke --steps 5 --device cpu \
        --amp bf16
    python -m repro_torch.launch.train --arch mamba2-130m --steps 5 --seq-len 512 --amp int8
    python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke --steps 3 --device cpu \
        --amp bf16

On the card the CLI refuses a config whose float32 weights, gradients and
AdamW moments (train_state_bytes) exceed the card's memory: mixtral-8x22b
at its 56 layers needs 2,250 GB, llama4-scout-17b-a16e at its 48 1,628 GB
and at 4 (its smallest legal depth, one pattern group) 166 GB,
recurrentgemma-9b at its 38 150 GB (at 5, one group and the tail, 34.8 GB
fit).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import MAX_D_HEAD
from repro_torch.core.parametrization import available_parametrizations
from repro_torch.core.transfer import HParams, transfer
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import weight_bytes
from repro_torch.models.model import build_model
from repro_torch.obs import MetricsRegistry, TrainObs, Tracer
from repro_torch.obs.telemetry import to_host
from repro_torch.optim import schedules as sched_lib
from repro_torch.optim.optimizer import Optimizer


WATCHDOG_FACTOR = 10.0   # a step this many times the recent median is flagged


class SimulatedFailure(RuntimeError):
    pass


def train_state_bytes(model) -> int:
    """Bytes a train step keeps on the device at the least: the model's
    float32 weights, their gradients and AdamW's two moments, 4x the
    weights' bytes (activations and the step's temporaries come on top)."""
    return 4 * weight_bytes(model)


def train_loop(
    cfg,
    steps: int,
    hps: HParams,
    ckpt_dir: Optional[str] = None,
    batch_size: int = 8,
    seq_len: int = 128,
    ckpt_every: int = 20,
    simulate_failure_at: Optional[int] = None,
    num_microbatches: int = 1,
    compress_grads: bool = False,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
    impl: str = "auto",
    obs: Optional[TrainObs] = None,
) -> Dict[str, Any]:
    """One training run (possibly resuming).  Returns the final metrics:
    ``final_loss``, ``losses``, ``params``, ``steps_run``,
    ``step_seconds`` (host clock per step, from the start of the batch's
    generation to the loss read back, as the reference times it) and
    ``batch_seconds`` (the part of it spent making the batch and copying it
    to the device).

    ``impl`` is the kernel dispatch of every norm and the loss
    (kernels/ops.py): ``"ref"`` runs the plain versions on the card too.

    ``obs`` (an obs.TrainObs) records each step's metrics after its loss
    is read back; with ``obs.tracer`` a ``train_step`` span a step, closed
    after that read-back (so it covers the step's device work); with
    ``obs.telemetry`` the step emits the µP-health statistics, read in one
    copy every ``obs.every`` steps into ``obs.ring``.
    """
    xfer = transfer(hps, cfg)
    cfg = cfg.replace(**xfer["model"])
    model = build_model(cfg, device=device, impl=impl)
    dev = model.device
    schedule = sched_lib.make_schedule(
        "linear", total_steps=steps, warmup_steps=hps.warmup_steps
    )
    opt = Optimizer.create(
        "adamw", parametrization=model.p13n, meta=model.meta,
        schedule=schedule, weight_decay=hps.weight_decay, **xfer["optim"],
    )
    telemetry = obs is not None and obs.telemetry
    step_fn = steps_lib.make_train_step(
        model, opt, num_microbatches=num_microbatches,
        compress_grads=compress_grads, telemetry=telemetry,
    )

    params = model.init(seed)
    opt_state = opt.init(params)
    start_step = 0

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        (params, opt_state), start_step, _ = ckpt.restore((params, opt_state))
        print(f"[train] resumed from step {start_step}")

    pipe = make_pipeline(cfg.vocab_size, seq_len, batch_size, seed=seed)
    losses = []
    step_times = []
    batch_times = []
    for t in range(start_step, steps):
        if simulate_failure_at is not None and t == simulate_failure_at:
            # drain in-flight async saves first: the injected crash models a
            # failure *between* steps, not one racing the last commit
            if ckpt:
                ckpt.wait()
            raise SimulatedFailure(f"injected node failure at step {t}")
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(t).items()}
        t1 = time.perf_counter()
        if obs is not None and obs.tracer is not None:
            with obs.tracer.span("train_step", phase="train_step", step=t):
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_times.append(dt)
        batch_times.append(t1 - t0)
        losses.append(loss)
        if obs is not None:
            aux = None
            if telemetry and t % max(obs.every, 1) == 0:
                aux = to_host(metrics["obs"])
            obs.record_step(
                t, loss=loss, grad_norm=float(metrics["grad_norm"]), dt=dt,
                tokens=batch_size * seq_len, width=cfg.d_model, aux=aux,
            )
        # straggler watchdog: flag steps >> median
        if len(step_times) > 10:
            med = float(np.median(step_times[-50:]))
            if dt > WATCHDOG_FACTOR * med:
                print(f"[watchdog] step {t} took {dt:.2f}s (median {med:.2f}s)")
        if log_every and t % log_every == 0:
            print(f"[train] step {t} loss {loss:.4f} ({dt * 1000:.0f} ms)")
        if ckpt and (t + 1) % ckpt_every == 0:
            ckpt.save(t + 1, (params, opt_state), async_save=True)
    if ckpt:
        ckpt.save(steps, (params, opt_state))
        ckpt.wait()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "params": params,
        "steps_run": steps - start_step,
        "step_seconds": step_times,
        "batch_seconds": batch_times,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mup-gpt")
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--width", type=float, default=None,
                    help="width factor vs the config (muTransfer family)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--parametrization", default="mup",
                    choices=[str(p) for p in available_parametrizations()])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--amp", default="", choices=["", "bf16", "int8"],
                    help="mixed-precision matmul policy (attention q·k/p·v "
                         "+ their backward + readout logits); master weights "
                         "and optimizer state stay f32")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree (not ported yet above 1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 weight sharding (not ported yet)")
    ap.add_argument("--telemetry", action="store_true",
                    help="emit the µP-health statistics from the train step "
                         "(activation coord sizes, logit scale, update/"
                         "weight ratios)")
    ap.add_argument("--obs-dir", default=None,
                    help="write metrics.prom / metrics.json / trace.jsonl "
                         "(+ telemetry.jsonl with --telemetry) here at exit; "
                         "implies metrics collection")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    # flag -> (set?, the slice of the port that brings it)
    not_ported = {
        "--model-parallel": (args.model_parallel != 1, "the multi-GPU slice"),
        "--fsdp": (args.fsdp, "the multi-GPU slice"),
    }
    for flag, (used, where) in not_ported.items():
        if used:
            ap.error(f"{flag} is not ported yet: it comes with {where}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(parametrization=args.parametrization, dtype="float32",
                      amp=args.amp)
    if args.width:
        cfg = cfg.scaled(args.width)
    if cfg.amp and cfg.d_head > MAX_D_HEAD and args.device != "cpu":
        ap.error(f"--amp on {cfg.name}: its d_head {cfg.d_head} is past the flash "
                 f"kernels' (B5-B7) range, d_head 1 to {MAX_D_HEAD}")
    model = build_model(cfg, device=args.device)
    if model.device.type == "cuda":
        need = train_state_bytes(model)
        have = torch.cuda.get_device_properties(model.device).total_memory
        if need > have:
            ap.error(f"{cfg.name}'s float32 weights, gradients and two AdamW moments need "
                     f"{need / 1e9:.1f} GB and the card has {have / 1e9:.1f} GB: training "
                     f"it needs sharded state over several cards, not ported yet "
                     f"(ROADMAP.md § A 5)")
    hps = HParams(lr=args.lr, sigma=args.sigma)

    obs = None
    if args.telemetry or args.obs_dir:
        obs = TrainObs(metrics=MetricsRegistry(), telemetry=args.telemetry,
                       tracer=Tracer() if args.obs_dir else None)

    kw = dict(
        steps=args.steps, hps=hps, ckpt_dir=args.ckpt_dir,
        batch_size=args.batch_size, seq_len=args.seq_len,
        ckpt_every=args.ckpt_every, num_microbatches=args.microbatches,
        compress_grads=args.compress_grads, seed=args.seed, device=args.device,
        obs=obs,
    )
    try:
        out = train_loop(cfg, simulate_failure_at=args.simulate_failure, **kw)
    except SimulatedFailure as e:
        print(f"[train] {e}; restarting from last checkpoint ...")
        if not args.ckpt_dir:
            raise
        out = train_loop(cfg, simulate_failure_at=None, **kw)
    if obs is not None and args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        obs.metrics.write_prometheus(os.path.join(args.obs_dir, "metrics.prom"))
        obs.metrics.write_json(os.path.join(args.obs_dir, "metrics.json"))
        if obs.ring is not None:
            with open(os.path.join(args.obs_dir, "telemetry.jsonl"), "w") as f:
                for rec in obs.ring.records:
                    f.write(json.dumps(rec) + "\n")
        obs.tracer.dump(os.path.join(args.obs_dir, "trace.jsonl"))
        print(f"[obs] wrote {args.obs_dir}/metrics.prom")
    print(f"[train] done: final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
