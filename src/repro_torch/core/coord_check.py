"""Coordinate checking (App. D.1, Fig. 5): the port's single-candidate form
of ``repro.core.coord_check``.

Train a family of models differing only in width for a few steps and
record the average coordinate size (mean |x|) of every logged activation,
and of its change from the initial params on the same batch.  Under µP
these stay Theta(1) as width grows; under SP, logits and attention logits
blow up.

The harness is model-agnostic: ``make_model(width)`` returns ``(params,
meta, loss_fn)`` with ``params`` a flat ``{name: tensor}`` dict, ``meta``
the model's meta, and ``loss_fn(params, batch)`` returning ``(loss, acts)``,
``acts`` a dict of named activation tensors.  Widths cannot share a step:
each trains on its own.  The reference's batched form (every learning-rate
candidate of a sweep at once) comes with the HP sweep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

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


def _loglog_slope(widths: Sequence[int], ys: Sequence[float]) -> float:
    """Least-squares slope of log2(ys) against log2(widths), in float64."""
    xs = [math.log2(w) for w in widths]
    ly = [math.log2(y) for y in ys]
    xbar, ybar = sum(xs) / len(xs), sum(ly) / len(ly)
    denom = sum((x - xbar) ** 2 for x in xs)
    return sum((x - xbar) * (y - ybar) for x, y in zip(xs, ly)) / denom


def _coord_size(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x.float()))


def coord_check(
    make_model: Callable[[int], Tuple[Dict[str, torch.Tensor], Any, Callable]],
    widths: Sequence[int],
    batches: Sequence[Any],
    parametrization,
    optimizer: str = "adam",
    lr: float = 1e-2,
    seed: int = 0,
) -> CoordCheckResult:
    """Run the coordinate check over ``widths``, training on ``batches``.

    Each width starts from ``make_model(width)``'s params and takes one
    optimizer step per batch.  The stats of a step are those of the params
    *before* its update (Fig. 5 logs x_t pre-update): per activation its
    mean |x| and, as ``"<name>.delta"``, the mean |x_t - x_0| on the same
    batch (which removes the µP init-GP artifact: the readout logits are
    Theta(1/sqrt(n)) at init by design, but their *updates* must be
    Theta(1)), and ``"__param_l1_drift__"``, the summed |params - params_0|.
    ``seed`` is accepted for the reference's signature; nothing here draws.
    """
    del seed
    records: Dict[int, List[Dict[str, float]]] = {}
    for width in widths:
        p0, meta, loss_fn = make_model(width)
        opt = Optimizer.create(optimizer, lr=lr, parametrization=parametrization,
                               meta=meta)
        params = {n: p.detach().clone() for n, p in p0.items()}
        state = opt.init(params)
        per_step: List[Dict[str, float]] = []
        for batch in batches:
            leaves = {n: p.requires_grad_(True) for n, p in params.items()}
            loss, acts = loss_fn(leaves, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            params = {n: p.detach() for n, p in leaves.items()}
            with torch.no_grad():
                _, acts0 = loss_fn(p0, batch)
                rec = {k: _coord_size(v) for k, v in acts.items()}
                for k, v in acts.items():
                    rec[f"{k}.delta"] = _coord_size(v - acts0[k])
                rec["__param_l1_drift__"] = sum(
                    torch.sum(torch.abs(params[n] - p0[n])) for n in params)
                updates, state = opt.update(grads, state, params)
                params = apply_updates(params, updates)
            per_step.append({k: float(v) for k, v in rec.items()})
        records[width] = per_step
    return CoordCheckResult(records=records)
