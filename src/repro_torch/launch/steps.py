"""The train step shared by launch/train.py and its callers.

The port's counterpart of ``repro.launch.steps.make_train_step``: one step
is forward, loss and backward through ``torch.autograd.grad`` over leaf
copies of the params (microbatched if asked), optional bf16 gradient
compression, global-norm clipping and the optimizer update.  PyTorch runs it
eagerly: there is no jit and no donation; the optimizer updates its moments
in place (optim/optimizer.py).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.optim.grad import (
    accumulate_gradients,
    clip_by_global_norm,
    compress_bf16,
)
from repro_torch.optim.optimizer import Optimizer, apply_updates


def make_train_step(
    model,
    opt: Optimizer,
    clip_norm: float = 1.0,
    num_microbatches: int = 1,
    compress_grads: bool = False,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``metrics`` holds the step's ``loss`` and pre-clip ``grad_norm`` as 0-d
    tensors on the model's device (reading them syncs).  opt_state grows a
    "residual" entry when gradient compression is on.
    """

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_gradients(
            model.loss_fn, params, batch, num_microbatches
        )
        opt_state = dict(opt_state)
        residual = opt_state.pop("residual", None)
        if compress_grads:
            grads, residual = compress_bf16(grads, residual)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, opt_state, params)
        if residual is not None:
            opt_state["residual"] = residual
        return apply_updates(params, updates), opt_state, {
            "loss": loss, "grad_norm": gnorm,
        }

    return train_step
