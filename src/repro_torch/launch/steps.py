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

from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.optim.grad import (
    accumulate_gradients,
    clip_by_global_norm,
    compress_bf16,
    value_and_grad,
)
from repro_torch.optim.optimizer import Optimizer, apply_updates


def make_train_step(
    model,
    opt: Optimizer,
    clip_norm: float = 1.0,
    num_microbatches: int = 1,
    compress_grads: bool = False,
    telemetry: bool = False,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``metrics`` holds the step's ``loss`` and pre-clip ``grad_norm`` as 0-d
    tensors on the model's device (reading them syncs).  opt_state grows a
    "residual" entry when gradient compression is on.

    ``telemetry`` adds ``metrics["obs"]``, the µP-health statistics of
    obs/telemetry.py: the forward's activation coordinate sizes (embedding,
    per-block residual stream, final norm, logits; pre-update, as the
    offline coord check logs x_t before the step) and ``u2w/<name>``, the
    update-to-weight ratio of every param, keyed and ordered as the
    reference's.  They stay on the card (``obs.telemetry.to_host`` reads a
    record in one copy) and read detached tensors, so loss, gradients and
    updates are those of the plain step bit for bit.
    """
    if telemetry and num_microbatches > 1:
        raise ValueError(
            "telemetry=True needs num_microbatches == 1: the health aux "
            "is the whole-batch forward's statistics (accumulation would "
            "average activations across microbatch forwards)"
        )

    def train_step(params, opt_state, batch):
        if telemetry:
            (loss, acts), grads = value_and_grad(
                lambda p, b: model.loss_fn(p, b, collect_stats=True), params,
                batch, has_aux=True,
            )
        else:
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
        metrics = {"loss": loss, "grad_norm": gnorm}
        if telemetry:
            aux = {**acts, **{f"u2w/{k}": v for k, v in
                              obs_telemetry.update_ratios(updates, params).items()}}
            metrics["obs"] = dict(sorted(aux.items()))
        return apply_updates(params, updates), opt_state, metrics

    return train_step
