"""HP search on the proxy model (Sec. 7 methodology), batched over candidates.

The port's counterpart of ``repro.core.tuning``.  Random search over
log-uniform/grid spaces, selecting by *training loss* (App. A: "using
training loss as the metric can be more robust to seed than validation
loss").  The paper's claim is that any tuner pointed at the proxy works;
this one is deliberately simple.

The engine is **batched**: N HP candidates (lr, sigma, alpha_*, lr_embed)
train at once.  Their params and optimizer moments are stacked on a leading
candidate axis, their HPs travel as a stacked :class:`RuntimeHP`, and the
batch is shared.  One step is

  1. ``torch.func.vmap`` of the forward and the loss only, over the stacked
     params and the RuntimeHP leaves (``in_dims=None`` for the batch): the
     (N,) losses.  B1 and B3, and under ``cfg.amp`` B5 (with the int8
     forward's pre-pass), run through their autograd Functions' vmap
     rules (kernels/ops.py): one launch each for all N candidates; the
     amp readout's and plain attention's policy matmuls
     (``quant.quant_matmul``) make one batched call.
  2. One ordinary ``.backward()`` of their sum: the candidates share no
     parameter, so each gets its own gradient; B2 and B4, and under amp
     B6 and B7 (with the int8 backward's pre-pass), run once each for all
     N.  No transform runs over the backward.
  3. ``Optimizer.update`` on the stacked tensors, the lr an (N,) tensor.

A candidate whose loss goes non-finite is frozen (its params and moments
keep their bits, its loss reads +inf), as the reference's
``jnp.where(ok, new, old)`` does.  So a step launches the same kernels
whatever N is, where the serial loop launches N times as many; on a
host-bound step that is the sweep's speedup.

Layers:

  - :func:`batched_train` — model-agnostic core: any (init_fn, loss_fn, opt)
    triple gets batched candidate training with divergence pruning.
  - :func:`train_proxy_batched` — the transformer proxy tuner (Sec. 7.1).
  - :func:`train_proxy_serial` — the serial loop with each candidate's HPs
    baked into its config as build-time constants: the proof that runtime
    HPs equal build-time ones, and the speed baseline.
  - :func:`random_search` — Sec. 7.1 random search, batched by default.

``launch/sweep.py`` adds the CLI.  A config's ``amp`` policy holds in
every path here, batched and serial; the models train in float32 master
weights (``dtype="float32"``), as in the reference.  Candidate sharding
over several cards is not ported (ROADMAP.md § A item 5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hpspace as hpspace_lib
from repro_torch.core.device import resolve_device
from repro_torch.core.hp import RuntimeHP, runtime_config_axes, stack_hparams
from repro_torch.core.hpspace import HPSpace
from repro_torch.core.init import init_candidates
from repro_torch.core.parametrization import resolve
from repro_torch.core.transfer import HParams
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models.model import build_model
from repro_torch.optim import schedules as sched_lib
from repro_torch.optim.optimizer import Optimizer, apply_updates

# EMA decay of the train-loss tuning metric (App. A); shared by the batched
# engine and both serial paths so their scores stay comparable.
EMA_DECAY = 0.7


class SearchSpace:
    """Deprecated shim: the App. F.1/F.3 log2 grids live as per-axis
    ``search`` lists on :class:`repro_torch.core.hpspace.HPSpace`.  Kept so
    ``SearchSpace(lr=..., sigma=...)`` call sites keep working; new code
    should use ``resolve(cfg.parametrization).hp_space()`` directly."""

    def __init__(self, space: Optional[HPSpace] = None, **search):
        self._space = (space or hpspace_lib.mup_space()).with_search(**search)

    @property
    def space(self) -> HPSpace:
        return self._space

    def sample(self, rng: np.random.RandomState) -> HParams:
        return self._space.sample(rng)

    def sample_n(self, n: int, seed: int = 0) -> List[HParams]:
        return self._space.sample_n(n, seed=seed)

    def __getattr__(self, name: str):
        # old dataclass-style field access: the axis' sweep candidates
        try:
            ax = self.__dict__["_space"].axis(name)
        except KeyError:
            raise AttributeError(name) from None
        return ax.search if ax.search is not None else (ax.default,)


def grid_candidates(
    base: Optional[HParams] = None,
    space: Optional[HPSpace] = None,
    **fields: Sequence[float],
) -> List[HParams]:
    """Cartesian-product HP grid, e.g. ``grid_candidates(lr=LRS, sigma=(0.5, 1))``
    — the Fig. 3/4 sweep shape.  Unswept fields keep ``base``'s values
    (space defaults when no base is given).  Delegates to
    :meth:`HPSpace.grid`, so axis names are validated and axes the space has
    fixed (``sigma`` under u-µP) are rejected."""
    return (space or hpspace_lib.mup_space()).grid(base=base, **fields)


def config_hparams(cfg, lr: float) -> HParams:
    """The HP bundle a config would train with when its values are baked in —
    the right ``base`` for grids that sweep one HP of a named config."""
    return HParams(
        lr=lr, **{n: getattr(cfg, n) for n in runtime_config_axes(cfg)}
    )


def _bake_hp_config(cfg, hps: HParams):
    """A config with a candidate's runtime HPs baked in as build-time
    constants (every runtime axis that is also a config field) — the serial
    counterpart of threading a RuntimeHP."""
    kw = {
        n: getattr(hps, n)
        for n in runtime_config_axes(cfg)
        if getattr(hps, n) is not None
    }
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# batched engine (model-agnostic core)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    """Per-candidate outcome of one (batched or serial) sweep run.

    losses: (N,) final EMA train loss — the tuning metric; inf if diverged.
    curves: (T, N) per-step train loss; inf once a candidate is pruned.
    active: (N,) bool — still alive at the end (not diverged, not pruned).
    """

    candidates: List[HParams]
    losses: np.ndarray
    curves: np.ndarray
    active: np.ndarray
    steps_run: int

    @property
    def best_index(self) -> int:
        return int(np.argmin(self.losses))

    @property
    def best(self) -> HParams:
        return self.candidates[self.best_index]

    @property
    def best_loss(self) -> float:
        return float(self.losses[self.best_index])

    def trials(self) -> List[Tuple[HParams, float]]:
        return list(zip(self.candidates, [float(x) for x in self.losses]))


def candidate_generators(seed: int, n: int, device="cuda") -> List[torch.Generator]:
    """Per-candidate init generators on ``device``: candidate i's seeded
    from ``(seed, i)`` through ``np.random.SeedSequence`` — the counterpart
    of the reference's ``fold_in(PRNGKey(seed), i)``, shared by the batched
    engine and the serial loop so their runs are comparable."""
    dev = resolve_device(device)
    return [
        torch.Generator(device=dev).manual_seed(
            int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]))
        for i in range(n)
    ]


def _leading(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """An (N,) tensor shaped to broadcast over (N, ...) of ``ndim`` dims."""
    return t.view(-1, *(1,) * (ndim - 1))


def make_batched_step(
    loss_fn: Callable[[Dict[str, torch.Tensor], Any, RuntimeHP], torch.Tensor],
    opt: Optimizer,
) -> Callable:
    """One candidate-batched step: ``(params, opt_state, active, hp, batch)
    -> (params, opt_state, loss, active)``, every tensor with the candidate
    axis leading (the batch shared).

    ``loss_fn(params, batch, hp)`` is one candidate's scalar loss; it runs
    under ``torch.func.vmap``.  A candidate whose loss goes non-finite is
    *pruned*: its params and optimizer state keep their bits, its recorded
    loss becomes +inf, and ``active`` turns (and stays) False.
    """
    batched = torch.func.vmap(loss_fn, in_dims=(0, None, 0))

    def step(params, opt_state, active, hp: RuntimeHP, batch):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        losses = batched(leaves, batch, hp)
        grads = dict(zip(leaves, torch.autograd.grad(losses.sum(), list(leaves.values()))))
        with torch.no_grad():
            losses = losses.detach()
            ok = active & torch.isfinite(losses)
            params = {n: p.detach() for n, p in leaves.items()}
            updates, opt_state = opt.update(grads, opt_state, params, lr=hp.lr,
                                            lr_embed=hp.lr_embed, active=ok)
            params = {n: torch.where(_leading(ok, p.ndim), p + updates[n], p)
                      for n, p in params.items()}
            loss = torch.where(ok, losses, torch.full_like(losses, math.inf))
        return params, opt_state, loss, ok

    return step


def batched_train(
    init_fn: Callable[[Sequence[torch.Generator], RuntimeHP], Dict[str, torch.Tensor]],
    loss_fn: Callable[[Dict[str, torch.Tensor], Any, RuntimeHP], torch.Tensor],
    opt: Optimizer,
    hp_stack: RuntimeHP,
    batches: Sequence[Any],
    *,
    seed: int = 0,
    ema_decay: float = EMA_DECAY,
    prune_factor: Optional[float] = None,
    prune_every: int = 10,
    stream: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
) -> Dict[str, Any]:
    """Train all N candidates of ``hp_stack`` at once (its leaves (N,)
    tensors on the device the run takes).

    init_fn(generators, hp_stack) -> params   (flat, stacked over N)
    loss_fn(params, batch, hp) -> scalar      (one candidate; vmapped)

    Pruning: divergence (non-finite loss) always prunes — the candidate's
    state freezes and its loss reads +inf from then on.  When
    ``prune_factor`` is set, every ``prune_every`` steps candidates whose
    EMA loss exceeds ``prune_factor *`` (current best EMA) are pruned too
    (their EMA score is frozen as-is).  The loop exits early once every
    candidate is pruned.  ``stream(t, losses, active)`` is invoked after
    every step with host numpy views.

    Returns {"losses", "curves", "active", "steps_run"} (numpy, see
    SweepResult) — the caller attaches the candidate list.
    """
    n = int(hp_stack.lr.shape[0])
    dev = hp_stack.lr.device
    params = init_fn(candidate_generators(seed, n, device=dev), hp_stack)
    opt_state = opt.init(params)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    step = make_batched_step(loss_fn, opt)

    total = len(batches)
    curves = np.full((total, n), np.inf, np.float32)
    ema = np.full((n,), np.nan, np.float64)
    steps_run = 0
    prev_active = np.ones((n,), bool)
    for t, batch in enumerate(batches):
        params, opt_state, loss, active = step(params, opt_state, active, hp_stack, batch)
        lf = loss.cpu().numpy().astype(np.float32)
        curves[t] = lf
        steps_run = t + 1
        # EMA: update while a candidate is alive; a non-finite loss while
        # alive is divergence -> score inf; already-pruned candidates keep
        # their frozen EMA (the loss row reads inf but is not a new datum).
        fresh = np.isnan(ema)
        with np.errstate(invalid="ignore"):
            stepped = np.where(
                np.isinf(lf), np.inf,
                np.where(fresh, lf, ema_decay * ema + (1 - ema_decay) * lf),
            )
        ema = np.where(prev_active, stepped, ema)
        act_np = active.cpu().numpy()
        if prune_factor is not None and (t + 1) % prune_every == 0 and act_np.any():
            best = float(np.min(ema[act_np]))
            if math.isfinite(best) and best > 0:
                act_np = act_np & (ema <= prune_factor * best)
                active = torch.as_tensor(act_np, device=dev)
        prev_active = act_np
        if stream is not None:
            stream(t, lf, act_np)
        if not act_np.any():
            break

    losses = np.where(np.isnan(ema), np.inf, ema).astype(np.float64)
    return {
        "losses": losses,
        "curves": curves[:steps_run],
        "active": active.cpu().numpy(),
        "steps_run": steps_run,
    }


# ---------------------------------------------------------------------------
# transformer proxy tuning (Sec. 7.1)
# ---------------------------------------------------------------------------

def _proxy_batches(cfg, steps: int, batch_size: int, seq_len: int, seed: int, device):
    pipe = make_pipeline(cfg.vocab_size, seq_len, batch_size, seed=seed)
    return [
        {k: torch.from_numpy(v).to(device) for k, v in pipe.batch(t).items()}
        for t in range(steps)
    ]


def _shared_scalar(candidates: Sequence[HParams], field: str):
    vals = {getattr(h, field) for h in candidates}
    if len(vals) > 1:
        raise ValueError(
            f"{field} is not vectorized by the batched engine; all candidates "
            f"in one batch must share it (got {sorted(vals)})"
        )
    return vals.pop()


def _validate_candidates(space: HPSpace, candidates: Sequence[HParams]) -> None:
    """Engine-side candidate validation, generated from the HP space:

    - ``engine="external"`` axes (schedule shape, warmup, regularization)
      are not implemented by the batched engine — non-default values are
      rejected loudly instead of training something else;
    - axes the space has *fixed* (sigma under u-µP) must stay at default.
    (``engine="shared"`` axes are checked by ``_shared_scalar`` where the
    shared value is actually consumed.)
    """
    for name in space.external_names():
        default = space.axis(name).default
        bad = {getattr(h, name) for h in candidates} - {default}
        if bad:
            raise ValueError(
                f"HParams.{name}={sorted(map(str, bad))} is not applied by "
                f"the batched engine (pass schedule= explicitly; retune "
                f"regularization at target scale); refusing to ignore it"
            )
    space.validate(candidates, context="sweep")


def _default_init(model):
    """Candidate i from its generator at its own sigma (core/init.py)."""
    return lambda gens, hp: init_candidates(
        gens, model.meta, model.p13n, hp.sigma.tolist())


def train_proxy_batched(
    cfg,
    candidates: Sequence[HParams],
    *,
    steps: int = 50,
    batch_size: int = 16,
    seq_len: int = 64,
    seed: int = 0,
    optimizer: str = "adamw",
    schedule=None,
    init_fn: Optional[Callable] = None,
    prune_factor: Optional[float] = None,
    prune_every: int = 10,
    stream: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
    device="cuda",
) -> SweepResult:
    """Train all candidates on the proxy at once (see the module note).

    lr / sigma / alpha_* / lr_embed vary per candidate; b1/b2/momentum and
    the schedule are structural and must be shared across the batch.  All
    candidates see the same data stream (seed) — HP comparison on identical
    batches — and candidate ``i`` inits from its generator of
    :func:`candidate_generators`.  ``init_fn(generators, hp_stack) ->
    stacked params`` replaces the init
    (the equivalence tests carry the reference's in through it).
    """
    candidates = list(candidates)
    space = resolve(cfg.parametrization).hp_space()
    # shared (structural) axes must match across the batch; their names are
    # Optimizer.create kwargs by construction (b1/b2/momentum)
    shared = {n: _shared_scalar(candidates, n) for n in space.shared_names()}
    _validate_candidates(space, candidates)
    cfg = cfg.replace(dtype="float32")
    model = build_model(cfg, device=device)
    hp_stack = stack_hparams(candidates, device=model.device)
    opt = Optimizer.create(
        optimizer, lr=0.0, parametrization=model.p13n, meta=model.meta,
        schedule=schedule or sched_lib.make_schedule("constant"), **shared,
    )
    out = batched_train(
        init_fn=init_fn or _default_init(model),
        loss_fn=lambda p, batch, hp: model.loss_fn(p, batch, hp=hp),
        opt=opt,
        hp_stack=hp_stack,
        batches=_proxy_batches(cfg, steps, batch_size, seq_len, seed, model.device),
        seed=seed,
        prune_factor=prune_factor,
        prune_every=prune_every,
        stream=stream,
    )
    return SweepResult(candidates=candidates, **out)


def _serial_step(model, opt):
    def step(params, opt_state, batch):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = model.loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            params = {n: p.detach() for n, p in leaves.items()}
            updates, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, float(loss)

    return step


def train_proxy_serial(
    cfg,
    candidates: Sequence[HParams],
    *,
    steps: int = 50,
    batch_size: int = 16,
    seq_len: int = 64,
    seed: int = 0,
    optimizer: str = "adamw",
    init_fn: Optional[Callable] = None,
    device="cuda",
) -> SweepResult:
    """The serial loop: one candidate at a time with its HPs baked into its
    config as Python constants — the pre-engine behaviour, with the
    engine's init, data and validation conventions, so results compare
    directly with :func:`train_proxy_batched` (the same init: candidate i's
    slice of ``init_fn(candidate_generators(seed, n), hp_stack)``)."""
    candidates = list(candidates)
    _validate_candidates(resolve(cfg.parametrization).hp_space(), candidates)
    n = len(candidates)
    cfg = cfg.replace(dtype="float32")
    dev = resolve_device(device)
    batches = _proxy_batches(cfg, steps, batch_size, seq_len, seed, dev)
    init = init_fn or _default_init(build_model(cfg, device=dev))
    stacked = init(candidate_generators(seed, n, device=dev),
                   stack_hparams(candidates, device=dev))

    curves = np.full((steps, n), np.inf, np.float32)
    losses = np.full((n,), np.inf, np.float64)
    active = np.zeros((n,), bool)
    for i, hps in enumerate(candidates):
        model = build_model(_bake_hp_config(cfg, hps), device=dev)
        params = {name: t[i].clone() for name, t in stacked.items()}
        opt = Optimizer.create(
            optimizer, lr=hps.lr, parametrization=model.p13n, meta=model.meta,
            b1=hps.b1, b2=hps.b2, momentum=hps.momentum,
            schedule=sched_lib.make_schedule("constant"), lr_embed=hps.lr_embed,
        )
        opt_state = opt.init(params)
        step = _serial_step(model, opt)
        ema = None
        alive = True
        for t, batch in enumerate(batches):
            params, opt_state, lf = step(params, opt_state, batch)
            if not math.isfinite(lf):
                ema, alive = float("inf"), False
                break
            curves[t, i] = lf
            ema = lf if ema is None else EMA_DECAY * ema + (1 - EMA_DECAY) * lf
        losses[i] = ema if ema is not None else float("inf")
        active[i] = alive
    return SweepResult(
        candidates=candidates, losses=losses, curves=curves,
        active=active, steps_run=steps,
    )


def train_proxy(
    cfg,
    hps: HParams,
    steps: int = 50,
    batch_size: int = 16,
    seq_len: int = 64,
    seed: int = 0,
    optimizer: str = "adamw",
    device="cuda",
) -> float:
    """Train the proxy briefly; return the final EMA train loss (the tuning
    metric), inf if it diverged.

    Single-candidate legacy path (own data stream per seed, ``Model.init``
    from the seed); sweeps should use :func:`train_proxy_batched`."""
    _validate_candidates(resolve(cfg.parametrization).hp_space(), [hps])
    cfg = _bake_hp_config(cfg, hps).replace(dtype="float32")
    model = build_model(cfg, device=device)
    params = model.init(seed)
    opt = Optimizer.create(
        optimizer, lr=hps.lr, parametrization=model.p13n, meta=model.meta,
        b1=hps.b1, b2=hps.b2, momentum=hps.momentum,
        schedule=sched_lib.make_schedule("constant"), lr_embed=hps.lr_embed,
    )
    opt_state = opt.init(params)
    step = _serial_step(model, opt)
    ema = None
    for batch in _proxy_batches(cfg, steps, batch_size, seq_len, seed, model.device):
        params, opt_state, lf = step(params, opt_state, batch)
        if not math.isfinite(lf):
            return float("inf")   # diverged — worst possible score
        ema = lf if ema is None else EMA_DECAY * ema + (1 - EMA_DECAY) * lf
    return ema if ema is not None else float("inf")


def random_search(
    proxy_cfg,
    n_samples: int = 16,
    space: Optional[SearchSpace] = None,
    steps: int = 50,
    batch_size: int = 16,
    seq_len: int = 64,
    seed: int = 0,
    eval_fn: Optional[Callable[[HParams], float]] = None,
    batched: bool = True,
    prune_factor: Optional[float] = None,
    device="cuda",
) -> Tuple[HParams, List[Tuple[HParams, float]]]:
    """Random HP search on the proxy (Sec. 7.1).  Returns (best, trials).

    With ``batched=True`` (default) all samples train at once through the
    batched engine on one shared data stream.  ``eval_fn`` (or
    ``batched=False``) takes the serial per-trial loop, where trial ``i``
    uses data seed ``seed + i`` (the legacy behaviour).

    The default search space comes from the proxy config's parametrization
    (u-µP proxies sweep the u-µP axis set — no sigma)."""
    space = space or SearchSpace(resolve(proxy_cfg.parametrization).hp_space())
    rng = np.random.RandomState(seed)
    samples = [space.sample(rng) for _ in range(n_samples)]
    if eval_fn is None and batched:
        res = train_proxy_batched(
            proxy_cfg, samples, steps=steps, batch_size=batch_size,
            seq_len=seq_len, seed=seed, prune_factor=prune_factor, device=device,
        )
        return res.best, res.trials()
    trials: List[Tuple[HParams, float]] = []
    for i, hps in enumerate(samples):
        if eval_fn is not None:
            score = eval_fn(hps)
        else:
            score = train_proxy(
                proxy_cfg, hps, steps=steps, batch_size=batch_size,
                seq_len=seq_len, seed=seed + i, device=device,
            )
        trials.append((hps, score))
    best = min(trials, key=lambda t: t[1])[0]
    return best, trials
