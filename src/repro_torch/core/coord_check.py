"""Coordinate checking (App. D.1, Fig. 5), batched over learning rates: the
port's counterpart of ``repro.core.coord_check``.

Train a family of models differing only in width for a few steps and
record the average coordinate size (mean |x|) of every logged activation,
and of its change from the initial params on the same batch.  Under µP
these stay Theta(1) as width grows; under SP, logits and attention logits
blow up.

The harness is model-agnostic: ``make_model(width)`` returns ``(params,
meta, loss_fn)`` with ``params`` a flat ``{name: tensor}`` dict, ``meta``
the model's meta, and ``loss_fn(params, batch)`` returning ``(loss, acts)``,
``acts`` a dict of named activation tensors.  Widths cannot share a step
(shapes differ), but learning-rate candidates at one width can:
:func:`coord_check_batched` trains N of them at once from one init on one
stream of batches, their params and moments stacked on a leading axis, the
forward under ``torch.func.vmap`` and one backward for all (as
core/tuning.py's engine does, under ``cfg.amp`` too: the flash kernels and
the policy matmuls take the candidate axis through their vmap rules).
:func:`coord_check` is its one-lr view; a batch of one candidate calls
``loss_fn`` directly, which is what a vmap over one computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizer import Optimizer, apply_updates


@dataclasses.dataclass
class CoordCheckResult:
    # records[width][t][act_name] = mean abs coordinate size
    records: Dict[int, List[Dict[str, float]]]

    def growth(self, act_name: str, t: int = -1) -> float:
        """log-log slope of coord size vs width at step t.

        ~0 for muP ("all activations Theta(1)"); >0 means blowup with width
        (SP logits), <0 means vanishing.
        """
        widths = sorted(self.records)
        ys = []
        for w in widths:
            recs = self.records[w]
            step = recs[t if t >= 0 else len(recs) + t]
            ys.append(max(step[act_name], 1e-30))
        return _loglog_slope(widths, ys)


@dataclasses.dataclass
class BatchedCoordCheckResult:
    """Coord-check records for N learning rates trained at once.

    records[width][t][act_name] is an ``(N,)`` array — one value per
    candidate.  ``lrs`` names the candidate axis.
    """

    lrs: Sequence[float]
    records: Dict[int, List[Dict[str, np.ndarray]]]

    def growth(self, act_name: str, candidate: int = 0, t: int = -1) -> float:
        widths = sorted(self.records)
        ys = []
        for w in widths:
            recs = self.records[w]
            step = recs[t if t >= 0 else len(recs) + t]
            ys.append(max(float(step[act_name][candidate]), 1e-30))
        return _loglog_slope(widths, ys)

    def candidate_view(self, candidate: int) -> CoordCheckResult:
        """Single-candidate slice with the classic CoordCheckResult schema."""
        return CoordCheckResult(records={
            w: [
                {k: float(v[candidate]) for k, v in step.items()}
                for step in recs
            ]
            for w, recs in self.records.items()
        })


def _loglog_slope(widths: Sequence[int], ys: Sequence[float]) -> float:
    """Least-squares slope of log2(ys) against log2(widths), in float64."""
    xs = [math.log2(w) for w in widths]
    ly = [math.log2(y) for y in ys]
    xbar, ybar = sum(xs) / len(xs), sum(ly) / len(ly)
    denom = sum((x - xbar) ** 2 for x in xs)
    return sum((x - xbar) * (y - ybar) for x, y in zip(xs, ly)) / denom


def _coord_size(x: torch.Tensor) -> torch.Tensor:
    """0-d mean |x| in float32 (the µP-health telemetry's statistic,
    obs/telemetry.py; a tensor on x's device, so reading it is the
    caller's choice)."""
    return torch.mean(torch.abs(x.float()))


def _coord_sizes(x: torch.Tensor) -> torch.Tensor:
    """(N,) mean |x| of each candidate of a stacked (N, ...) tensor."""
    return torch.mean(torch.abs(x.float()).reshape(x.shape[0], -1), dim=1)


def _over_candidates(loss_fn, n: int):
    """``loss_fn(params, batch)`` over params stacked on a leading axis of
    n: ``torch.func.vmap``, or for one candidate the call itself with the
    axis put back."""
    if n > 1:
        return torch.func.vmap(loss_fn, in_dims=(0, None))

    def one(params, batch):
        loss, acts = loss_fn({k: p[0] for k, p in params.items()}, batch)
        return loss[None], {k: v[None] for k, v in acts.items()}

    return one


def coord_check_batched(
    make_model: Callable[[int], Tuple[Dict[str, torch.Tensor], Any, Callable]],
    widths: Sequence[int],
    batches: Sequence[Any],
    parametrization,
    optimizer: str = "adam",
    lrs: Sequence[float] = (1e-2,),
    seed: int = 0,
) -> BatchedCoordCheckResult:
    """Run the coordinate check over ``widths`` x ``lrs``, training on
    ``batches``.

    make_model(width) -> (params, meta, loss_fn) where
    loss_fn(params, batch) -> (loss, acts_dict).  All LR candidates start
    from the same init and see the same batches; each evolves its own
    stacked (params, opt state) copy.  The stats of a step are those of the
    params *before* its update (Fig. 5 logs x_t pre-update): per activation
    its mean |x| and, as ``"<name>.delta"``, the mean |x_t - x_0| on the
    same batch (which removes the µP init-GP artifact: the readout logits
    are Theta(1/sqrt(n)) at init by design, but their *updates* must be
    Theta(1)), and ``"__param_l1_drift__"``, the summed |params - params_0|.
    ``seed`` is accepted for the reference's signature; nothing here draws.
    """
    del seed
    n = len(lrs)
    records: Dict[int, List[Dict[str, np.ndarray]]] = {}
    for width in widths:
        p0, meta, loss_fn = make_model(width)
        opt = Optimizer.create(optimizer, lr=0.0, parametrization=parametrization,
                               meta=meta)
        dev = next(iter(p0.values())).device
        lr_vec = torch.tensor(list(lrs), dtype=torch.float32, device=dev)
        params = {k: p.detach()[None].expand(n, *p.shape).clone() for k, p in p0.items()}
        state = opt.init(params)
        batched = _over_candidates(loss_fn, n)
        per_step: List[Dict[str, np.ndarray]] = []
        for batch in batches:
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            loss, acts = batched(leaves, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss.sum(),
                                                         list(leaves.values()))))
            params = {k: p.detach() for k, p in leaves.items()}
            with torch.no_grad():
                _, acts0 = loss_fn(p0, batch)   # the initial params: shared
                rec = {k: _coord_sizes(v) for k, v in acts.items()}
                for k, v in acts.items():
                    rec[f"{k}.delta"] = _coord_sizes(v - acts0[k][None])
                rec["__param_l1_drift__"] = sum(
                    torch.sum(torch.abs(params[k] - p0[k][None]).reshape(n, -1), dim=1)
                    for k in params)
                updates, state = opt.update(grads, state, params, lr=lr_vec)
                params = apply_updates(params, updates)
            per_step.append({k: v.detach().cpu().numpy().astype(np.float32)
                             for k, v in rec.items()})
        records[width] = per_step
    return BatchedCoordCheckResult(lrs=list(lrs), records=records)


def coord_check(
    make_model: Callable[[int], Tuple[Dict[str, torch.Tensor], Any, Callable]],
    widths: Sequence[int],
    batches: Sequence[Any],
    parametrization,
    optimizer: str = "adam",
    lr: float = 1e-2,
    seed: int = 0,
) -> CoordCheckResult:
    """Single-LR coordinate check (classic API) — a one-candidate batch of
    :func:`coord_check_batched`, whose docstring says what is recorded."""
    res = coord_check_batched(
        make_model, widths, batches, parametrization,
        optimizer=optimizer, lrs=(lr,), seed=seed,
    )
    return res.candidate_view(0)
