"""Sweep CLI: streaming, pruning HP sweeps on one card.

The port's counterpart of ``python -m repro.launch.sweep``, with the same
flags and printout.  It wraps the batched engine
(``core.tuning.train_proxy_batched``: N candidates at once, their states
stacked on a leading axis, B1-B4 launched once a step for all N) with

  - **streaming**: per-interval best-loss / alive-count lines while the
    sweep runs, then a ranking of every candidate;
  - **pruning**: divergence always prunes; ``--prune-factor`` also drops
    candidates whose EMA loss exceeds factor x the running best (checked
    every ``--prune-every`` steps).

The sweep runs on one card (``--device cpu`` for the CPU), under the
config's own ``amp`` policy as the reference's does (no flag sets it: under
amp, B5-B7 run once a layer a step for all candidates).  ``run_sweep``'s
``tracer`` (an ``obs.Tracer``) records the candidate lifecycle: one
``sweep`` span, ``prune`` events naming the pruned candidates and a
``sweep_done`` event with the best one.  Not ported yet, and refused with a
message: sharding the candidate axis over several cards (``--devices``
above 1, ``n_devices`` above 1; the multi-GPU slice, ROADMAP.md § A item 5).

Usage:
    python -m repro_torch.launch.sweep --arch mup-gpt --full --n 16 --steps 30
    python -m repro_torch.launch.sweep --arch mup-gpt --lrs 1e-3,2e-3,4e-3 \
        --steps 50 --prune-factor 3.0 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.parametrization import available_parametrizations, resolve
from repro_torch.core.transfer import HParams
from repro_torch.core.tuning import SweepResult, grid_candidates, train_proxy_batched

MULTI_CARD = ("candidate sharding over several cards is not ported yet: it "
              "comes with the multi-GPU slice (ROADMAP.md § A item 5)")


def run_sweep(
    cfg,
    candidates: Sequence[HParams],
    *,
    steps: int = 50,
    batch_size: int = 16,
    seq_len: int = 64,
    seed: int = 0,
    optimizer: str = "adamw",
    prune_factor: Optional[float] = None,
    prune_every: int = 10,
    n_devices: Optional[int] = None,
    log_every: int = 10,
    verbose: bool = True,
    tracer=None,
    device="cuda",
) -> SweepResult:
    """Run a batched HP sweep on one device, streaming its progress.

    ``tracer`` (an ``obs.Tracer``) records the candidate lifecycle: one
    ``sweep`` span for the run, a ``prune`` instant event whenever the
    alive count drops (with the pruned candidate indices), and a final
    ``sweep_done`` event carrying the best candidate.  ``n_devices``
    (above 1) is refused: candidate sharding over several cards is not
    ported yet.
    """
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(MULTI_CARD)
    candidates = list(candidates)
    if not candidates:
        raise ValueError("run_sweep: empty candidate list")
    n = len(candidates)
    if verbose:
        print(f"[sweep] {n} candidates x {steps} steps on 1 device ({device}); "
              f"optimizer={optimizer}")

    prev_active = np.ones((n,), bool)

    def stream(t: int, losses: np.ndarray, active: np.ndarray):
        nonlocal prev_active
        if verbose and log_every and (t % log_every == 0 or t == steps - 1):
            alive = losses[active]
            best = float(alive.min()) if alive.size else float("inf")
            print(f"[sweep] step {t:4d}  best loss {best:.4f}  "
                  f"alive {int(active.sum())}/{n}", flush=True)
        if tracer is not None:
            act = np.asarray(active, bool)
            pruned = np.nonzero(prev_active & ~act)[0]
            if pruned.size:
                tracer.event("prune", step=t,
                             candidates=[int(i) for i in pruned],
                             alive=int(act.sum()))
            prev_active = act

    t0 = time.time()
    span = (tracer.span("sweep", candidates=n, steps=steps, devices=1)
            if tracer is not None else contextlib.nullcontext())
    with span:
        res = train_proxy_batched(
            cfg, candidates, steps=steps, batch_size=batch_size,
            seq_len=seq_len, seed=seed, optimizer=optimizer,
            prune_factor=prune_factor, prune_every=prune_every, stream=stream,
            device=device,
        )
    dt = time.time() - t0
    if tracer is not None:
        tracer.event("sweep_done", best=res.best_index,
                     best_loss=res.best_loss, steps_run=int(res.steps_run))
    if verbose:
        rate = n * res.steps_run / max(dt, 1e-9)
        print(f"[sweep] done in {dt:.1f}s — {rate:.1f} candidate-steps/sec")
    return res


def _parse_candidates(ap, args, cfg) -> List[HParams]:
    # the sweepable axis set comes from the config's parametrization
    # (u-µP: no sigma axis) — resolved through the registry
    space = resolve(cfg.parametrization).hp_space()
    if args.lrs:
        try:
            lrs = tuple(float(x) for x in args.lrs.split(",") if x)
        except ValueError:
            ap.error(f"--lrs must be comma-separated floats, got {args.lrs!r}")
        if not lrs:
            ap.error("--lrs is empty")
        fields = dict(lr=lrs)
        if not space.axis("sigma").fixed:
            fields["sigma"] = (args.sigma,)
        elif args.sigma != 1.0:
            ap.error(f"--sigma is not an axis of the {space.name} HP space")
        try:
            return grid_candidates(space=space, **fields)
        except ValueError as e:
            ap.error(str(e))
    if args.n < 1:
        ap.error("--n must be >= 1")
    return space.sample_n(args.n, seed=args.seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mup-gpt")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke config)")
    ap.add_argument("--parametrization", default=None,
                    choices=[str(p) for p in available_parametrizations()],
                    help="override the config's rule (registry name)")
    ap.add_argument("--n", type=int, default=16,
                    help="random-search candidate count")
    ap.add_argument("--lrs", default=None,
                    help="comma-separated LR grid (overrides --n)")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--prune-factor", type=float, default=None)
    ap.add_argument("--prune-every", type=int, default=10)
    ap.add_argument("--devices", type=int, default=None,
                    help="cards to shard the candidates over (only 1 is "
                         "ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to sweep on (default: the card)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices > 1:
        ap.error(f"--devices {args.devices}: {MULTI_CARD}")

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    if args.parametrization:
        cfg = cfg.replace(parametrization=args.parametrization)
    candidates = _parse_candidates(ap, args, cfg)
    res = run_sweep(
        cfg, candidates, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, seed=args.seed, optimizer=args.optimizer,
        prune_factor=args.prune_factor, prune_every=args.prune_every,
        device=args.device,
    )
    order = np.argsort(res.losses)
    print(f"[sweep] ranking ({len(order)} candidates):")
    for rank, i in enumerate(order):
        h = res.candidates[i]
        tag = "" if res.active[i] else "  [pruned]"
        print(
            f"  #{rank:<3d} loss {res.losses[i]:<10.4f} lr={h.lr:.3e} "
            f"sigma={h.sigma:g} a_out={h.alpha_output:g} "
            f"a_attn={h.alpha_attn:g} a_embed={h.alpha_embed:g}{tag}"
        )
    best = res.best
    print(f"[sweep] best: lr={best.lr:.3e} sigma={best.sigma:g} "
          f"alpha_output={best.alpha_output:g} (loss {res.best_loss:.4f})")
    return res


if __name__ == "__main__":
    main()
