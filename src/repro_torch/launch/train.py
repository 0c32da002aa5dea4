"""Training entry point: the port's counterpart of ``python -m repro.launch.train``.

On the card by default (``--device cpu`` for the CPU):
  - muP-parametrized model + muP AdamW with per-tensor LRs, the loss through
    the chunked cross-entropy kernels and every RMSNorm forward and backward
    through its kernel,
  - ``--amp bf16``: the mixed-precision policy; attention forward and
    backward through the flash-attention kernels with bf16 tile-matmul
    operands, the readout logit matmul in bf16 operands (master weights and
    optimizer state stay f32),
  - deterministic stateless-resumable synthetic data (the reference's
    batches, bit for bit),
  - step-atomic checkpoints with async writes,
  - checkpoint/restart fault tolerance: ``--simulate-failure N`` raises at
    step N, then main() restarts the loop in-process and resumes from the
    last committed checkpoint,
  - per-step wall-clock watchdog (straggler detection),
  - optional bf16 gradient compression and microbatch accumulation.

Flags of parts not ported yet (``--amp int8``, ``--model-parallel`` above
1, ``--fsdp``, ``--telemetry``, ``--obs-dir``) exit with an error naming the
slice that brings them.

Usage:
    python -m repro_torch.launch.train --arch mup-gpt --steps 20 --seq-len 512
    python -m repro_torch.launch.train --arch mup-gpt --amp bf16 --steps 20 --seq-len 512
    python -m repro_torch.launch.train --arch mup-gpt --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.parametrization import available_parametrizations
from repro_torch.core.transfer import HParams, transfer
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import build_model
from repro_torch.optim import schedules as sched_lib
from repro_torch.optim.optimizer import Optimizer


WATCHDOG_FACTOR = 10.0   # a step this many times the recent median is flagged


class SimulatedFailure(RuntimeError):
    pass


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
) -> Dict[str, Any]:
    """One training run (possibly resuming).  Returns the final metrics:
    ``final_loss``, ``losses``, ``params``, ``steps_run``,
    ``step_seconds`` (host clock per step, from the start of the batch's
    generation to the loss read back, as the reference times it) and
    ``batch_seconds`` (the part of it spent making the batch and copying it
    to the device).

    ``impl`` is the kernel dispatch of every norm and the loss
    (kernels/ops.py): ``"ref"`` runs the plain versions on the card too.
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
    step_fn = steps_lib.make_train_step(
        model, opt, num_microbatches=num_microbatches,
        compress_grads=compress_grads,
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
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_times.append(dt)
        batch_times.append(t1 - t0)
        losses.append(loss)
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
                         "and optimizer state stay f32 (int8 not ported yet)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree (not ported yet above 1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 weight sharding (not ported yet)")
    ap.add_argument("--telemetry", action="store_true",
                    help="µP-health aux from the train step (not ported yet)")
    ap.add_argument("--obs-dir", default=None,
                    help="metrics and trace output (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    # flag -> (set?, the slice of the port that brings it)
    not_ported = {
        "--amp int8": (args.amp == "int8", "the int8 slice of the "
                                           "flash-attention kernels (B5-B7)"),
        "--model-parallel": (args.model_parallel != 1, "the multi-GPU slice"),
        "--fsdp": (args.fsdp, "the multi-GPU slice"),
        "--telemetry": (args.telemetry, "the observability slice"),
        "--obs-dir": (args.obs_dir is not None, "the observability slice"),
    }
    for flag, (used, where) in not_ported.items():
        if used:
            ap.error(f"{flag} is not ported yet: it comes with {where}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(parametrization=args.parametrization, dtype="float32",
                      amp=args.amp)
    if args.width:
        cfg = cfg.scaled(args.width)
    hps = HParams(lr=args.lr, sigma=args.sigma)

    kw = dict(
        steps=args.steps, hps=hps, ckpt_dir=args.ckpt_dir,
        batch_size=args.batch_size, seq_len=args.seq_len,
        ckpt_every=args.ckpt_every, num_microbatches=args.microbatches,
        compress_grads=args.compress_grads, seed=args.seed, device=args.device,
    )
    try:
        out = train_loop(cfg, simulate_failure_at=args.simulate_failure, **kw)
    except SimulatedFailure as e:
        print(f"[train] {e}; restarting from last checkpoint ...")
        if not args.ckpt_dir:
            raise
        out = train_loop(cfg, simulate_failure_at=None, **kw)
    print(f"[train] done: final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
