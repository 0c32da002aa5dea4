"""Experiment — the one-object muTransfer workflow (Algorithm 1 as an API).

The port's counterpart of ``repro.api``.  ``Experiment`` wires configs,
model, init, optimizer, the batched sweep and the train loop:

    from repro_torch.api import Experiment

    exp    = Experiment.from_config("mup-gpt", smoke=False)  # muP target, on the card
    proxy  = exp.proxy(width_factor=0.25)             # Algorithm 1 step 2 model
    proxy.coord_check(lrs=(1e-3, 1e-2, 1e-1))         # verify the parametrization
    result = proxy.tune(n_samples=16, steps=30)       # batched HP sweep
    target = proxy.transfer(exp)                      # zero-shot HP copy
    target.train(steps=200)                           # train the target

Each Experiment is a (ModelConfig, optional tuned HParams, device) triple;
the device is the card unless the caller asks for the CPU
(``device="cpu"``).  The parametrization is resolved from the config string
through the registry (``repro_torch.core.parametrization``), so a rule added
with ``register()`` — including the built-in u-µP — gets the whole workflow,
with its own HP space (u-µP sweeps no ``sigma``).  A config's ``amp``
policy ("bf16" or "int8") holds through the whole workflow, as in the
reference: the proxy keeps it, and ``coord_check``, ``tune`` and ``train``
run under it (on the card the batched steps launch B5-B7 once a layer for
all candidates).

``train(obs=...)`` threads an ``obs.TrainObs`` (metrics, µP-health
telemetry, drift detection, tracer) through the train loop.  Not ported
yet, and refused: ``serving_engine(mesh=...)`` (the multi-GPU slice,
ROADMAP.md § A item 5).  Lower-level handles (``build()``, ``optimizer()``)
stay available for custom training loops.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import coord_check as coord_check_lib
from repro_torch.core import transfer as transfer_lib
from repro_torch.core import tuning as tuning_lib
from repro_torch.core.device import resolve_device
from repro_torch.core.hpspace import HParams, HPSpace
from repro_torch.core.parametrization import AbcParametrization, resolve
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizer import Optimizer


@dataclasses.dataclass
class Experiment:
    """A model config + (optionally) the HPs tuned for it, on a device."""

    cfg: ModelConfig
    hps: Optional[HParams] = None
    device: Any = "cuda"

    # ------------------------------------------------------------------
    @classmethod
    def from_config(
        cls,
        arch: Union[str, ModelConfig],
        smoke: bool = True,
        width: Optional[float] = None,
        parametrization: Optional[str] = None,
        device="cuda",
        **overrides,
    ) -> "Experiment":
        """Build from an arch name (``"mup-gpt"``, ``"smollm-135m"``, ...)
        or an explicit ModelConfig.  ``smoke`` selects the reduced config;
        ``width`` scales the muTransfer family; ``parametrization`` swaps
        the rule (any registered name); other kwargs are config overrides."""
        if isinstance(arch, ModelConfig):
            cfg = arch
        else:
            cfg = (get_smoke_config if smoke else get_config)(arch)
        if parametrization is not None:
            resolve(parametrization)  # fail fast on unknown names
            cfg = cfg.replace(parametrization=parametrization)
        if width is not None:
            cfg = cfg.scaled(width)
        if overrides:
            cfg = cfg.replace(**overrides)
        return cls(cfg=cfg, device=device)

    # ------------------------------------------------------------------
    @property
    def parametrization(self) -> AbcParametrization:
        return resolve(self.cfg.parametrization)

    @property
    def space(self) -> HPSpace:
        """The muTransferable HP space of this experiment's parametrization."""
        return self.parametrization.hp_space()

    # ------------------------------------------------------------------
    def build(self) -> Model:
        """The assembled model on this experiment's device (params come from
        ``model.init(seed)``)."""
        return build_model(self.cfg, device=self.device)

    def optimizer(
        self,
        kind: str = "adamw",
        hps: Optional[HParams] = None,
        model: Optional[Model] = None,
        **kw,
    ) -> Optimizer:
        """A muP-aware optimizer wired to this experiment's meta/rule/HPs."""
        hps = hps or self.hps or self.space.hparams()
        model = model or self.build()
        kw.setdefault("lr", hps.lr)
        kw.setdefault("b1", hps.b1)
        kw.setdefault("b2", hps.b2)
        kw.setdefault("momentum", hps.momentum)
        kw.setdefault("lr_embed", hps.lr_embed)
        return Optimizer.create(
            kind, parametrization=model.p13n, meta=model.meta, **kw
        )

    # ------------------------------------------------------------------
    def proxy(
        self,
        width_factor: float = 0.25,
        depth: Optional[int] = None,
        min_d_head: int = 32,
    ) -> "Experiment":
        """The Algorithm-1 step-2 tuning proxy (same muP base shape)."""
        return dataclasses.replace(self, cfg=transfer_lib.make_proxy(
            self.cfg, width_factor=width_factor, depth=depth,
            min_d_head=min_d_head,
        ))

    # ------------------------------------------------------------------
    def serving_engine(
        self,
        engine_config=None,
        drafter: Optional["Experiment"] = None,
        mesh=None,
        **ecfg_overrides,
    ):
        """A continuous-batching serving engine for this experiment's model.

        Pass ``drafter`` — typically ``self.proxy(width_factor, ...)``, the
        same narrow µP proxy used for HP tuning — to serve speculatively
        (``draft_k`` defaults to 4 when a drafter is given).  Returns the
        engine; call ``engine.serve(params, ..., draft_params=...)`` with
        each model's own params.  The dynamic-allocator knobs
        (``prefix_cache``, ``prefill_chunk``, ``n_pages``,
        ``n_window_pages``) select the ``DynamicEngine``, as in the
        reference; otherwise the static ``Engine``.  ``mesh`` is refused:
        multi-GPU serving is not ported yet (ROADMAP.md § A item 5).
        """
        if mesh is not None:
            raise NotImplementedError(
                "serving over a mesh is not ported yet: it comes with the "
                "multi-GPU slice (ROADMAP.md § A item 5)")
        from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig

        if engine_config is None:
            if drafter is not None:
                ecfg_overrides.setdefault("draft_k", 4)
            engine_config = EngineConfig(**ecfg_overrides)
        elif ecfg_overrides:
            engine_config = dataclasses.replace(engine_config, **ecfg_overrides)
        draft_model = None if drafter is None else drafter.build()
        dynamic = (
            engine_config.prefix_cache or engine_config.prefill_chunk
            or engine_config.n_pages is not None
            or engine_config.n_window_pages is not None
        )
        cls = DynamicEngine if dynamic else Engine
        return cls(self.build(), engine_config, draft_model=draft_model)

    # ------------------------------------------------------------------
    def coord_check(
        self,
        widths: Sequence[float] = (1.0, 2.0, 4.0),
        steps: int = 3,
        lr: float = 1e-2,
        lrs: Optional[Sequence[float]] = None,
        batch_size: int = 8,
        seq_len: int = 32,
        optimizer: str = "adam",
        seed: int = 0,
        zero_init: bool = False,
    ):
        """App. D.1 coordinate check over width multiples of this config.

        Returns a ``CoordCheckResult`` keyed by actual d_model (or a
        ``BatchedCoordCheckResult`` when ``lrs`` gives several learning
        rates, trained at once).  Under a correct muP-class rule every
        activation's ``growth`` slope stays ~0.  (The port's configs tie
        their embeddings, so ``zero_init`` zeroes the query projection.)
        """
        base = self.cfg.replace(dtype="float32", zero_init_query=zero_init)
        widths = list(widths)

        def make_model(i: int):
            model = build_model(base.scaled(widths[i]), device=self.device)
            params = model.init(seed)

            def loss_fn(params, batch):
                return model.loss_fn(params, batch, collect_acts=True)

            return params, model.meta, loss_fn

        dev = resolve_device(self.device)
        pipe = make_pipeline(base.vocab_size, seq_len, batch_size, seed=seed)
        batches = [
            {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(t).items()}
            for t in range(steps)
        ]
        res = coord_check_lib.coord_check_batched(
            make_model, list(range(len(widths))), batches,
            self.parametrization, optimizer=optimizer,
            lrs=tuple(lrs) if lrs is not None else (lr,), seed=seed,
        )
        # re-key records by the actual model width
        res.records = {
            int(base.scaled(widths[i]).d_model): v
            for i, v in res.records.items()
        }
        if lrs is None:
            return res.candidate_view(0)
        return res

    # ------------------------------------------------------------------
    def tune(
        self,
        candidates: Optional[Sequence[HParams]] = None,
        n_samples: int = 16,
        steps: int = 40,
        batch_size: int = 8,
        seq_len: int = 64,
        seed: int = 0,
        optimizer: str = "adamw",
        prune_factor: Optional[float] = None,
        **kw,
    ) -> tuning_lib.SweepResult:
        """Batched HP sweep on *this* experiment's model (call it on the
        proxy).  Candidates default to ``n_samples`` draws from this
        parametrization's HP space; the winner is stored on ``self.hps``
        for a subsequent ``transfer()`` / ``train()``."""
        if candidates is None:
            candidates = self.space.sample_n(n_samples, seed=seed)
        res = tuning_lib.train_proxy_batched(
            self.cfg, candidates, steps=steps, batch_size=batch_size,
            seq_len=seq_len, seed=seed, optimizer=optimizer,
            prune_factor=prune_factor, device=self.device, **kw,
        )
        self.hps = res.best
        return res

    # ------------------------------------------------------------------
    def transfer(
        self, target: Union["Experiment", ModelConfig],
        hps: Optional[HParams] = None,
    ) -> "Experiment":
        """Zero-shot muTransfer (Algorithm 1 step 3): carry this
        experiment's tuned HPs to ``target`` (validated against the target
        parametrization's HP space).  Returns the target Experiment, on the
        target's device (this one's for a bare config)."""
        hps = hps or self.hps
        if hps is None:
            raise ValueError(
                "transfer() needs tuned HPs: call tune() first or pass hps="
            )
        if isinstance(target, Experiment):
            cfg, device = target.cfg, target.device
        else:
            cfg, device = target, self.device
        transfer_lib.transfer(hps, cfg)  # validation + regularization warning
        return Experiment(cfg=cfg, hps=hps, device=device)

    def transfer_plan(self, hps: Optional[HParams] = None) -> Dict[str, Any]:
        """The raw (model / optim / schedule) override dict for this
        experiment's HPs — what ``train()`` applies under the hood."""
        hps = hps or self.hps or self.space.hparams()
        return transfer_lib.transfer(hps, self.cfg)

    # ------------------------------------------------------------------
    def train(
        self,
        steps: int = 100,
        hps: Optional[HParams] = None,
        batch_size: int = 8,
        seq_len: int = 128,
        obs=None,
        **kw,
    ) -> Dict[str, Any]:
        """Train this experiment's model with its (tuned or given) HPs via
        the end-to-end train loop (``launch.train.train_loop``: B1-B4 on
        the card, checkpointing, watchdog).  Returns the loop's metrics
        dict.

        ``obs``: an :class:`repro_torch.obs.TrainObs`, the metrics registry
        and, with ``telemetry=True``, the online µP-health statistics
        (activation/logit coordinate sizes + update-to-weight ratios) with
        optional drift detection against a proxy baseline."""
        from repro_torch.launch.train import train_loop  # deferred: heavy imports

        hps = hps or self.hps or self.space.hparams()
        kw.setdefault("device", self.device)
        return train_loop(
            self.cfg, steps=steps, hps=hps, batch_size=batch_size,
            seq_len=seq_len, obs=obs, **kw,
        )
