"""The copy task: the workload on which speculation's acceptance is measured.

The port's counterpart of the reference's ``benchmarks/perf_serve.py``
``_train_copy`` and the prompts of its ``_spec_bench``.  Each sequence is one
token repeated and the labels are the tokens, so a model learns to emit the
previous token: the cheapest rule that a target and its µP proxy, trained
apart, reliably agree on.  With random weights a drafter's acceptance is near
chance; after a few hundred steps on this task it is near one, so the two
bracket what speculation can gain.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import build_model
from repro_torch.optim.grad import value_and_grad
from repro_torch.optim.optimizer import Optimizer, apply_updates


def copy_batch(rng: np.random.RandomState, vocab: int, batch: int, seq: int):
    """(batch, seq) int64: each row one random token repeated."""
    return np.tile(rng.randint(0, vocab, size=(batch, 1)), (1, seq))


def train_copy(cfg, steps: int = 60, batch: int = 16, seq: int = 32,
               seed: int = 0, device="cuda", lr: float = 1e-2):
    """Train a fresh model of ``cfg`` (init from ``seed``) on the copy task
    with Adam under its parametrization, at the reference's lr 1e-2 unless
    given (it diverges at smollm-135m's full width and vocabulary:
    ``scripts/torch_copy_lr_probe.py``).  Returns (model, params, the
    losses of every step)."""
    model = build_model(cfg, device=device)
    params = model.init(seed)
    opt = Optimizer.create("adam", lr=lr, parametrization=model.p13n,
                           meta=model.meta)
    state = opt.init(params)
    rng = np.random.RandomState(seed + 100)
    losses = []
    for _ in range(steps):
        toks = torch.as_tensor(copy_batch(rng, cfg.vocab_size, batch, seq),
                               device=model.device)
        loss, grads = value_and_grad(model.loss_fn, params,
                                     {"tokens": toks, "labels": toks})
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
        losses.append(float(loss))
    return model, params, losses
