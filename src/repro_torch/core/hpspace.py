"""HPSpace — the single declarative description of the muTransferable HP set.

The port's copy of ``repro.core.hpspace`` (numpy only).  Each
:class:`HPAxis` declares, for one named HP (a row of the paper's Table 1/2):
its default and Table-1 category, whether it muTransfers
(``transferable``), how a batched sweep treats it (``engine``: a
per-candidate ``"runtime"`` scalar, a ``"shared"`` structural value, or
``"external"``), where :func:`repro_torch.core.transfer.transfer` copies it
(``dest``) and its default proxy-sweep candidates (``search``).  From the
axis list the rest is generated: the frozen :class:`HParams` candidate, the
``MU_TRANSFERABLE`` / ``NOT_TRANSFERABLE`` sets and the transfer plan.  The
reference's sampling and grid methods arrive with the port's sweep.

Parametrizations own their HP space: ``AbcParametrization.hp_space()``.
µP/SP/NTK share :func:`mup_space`; u-µP uses :func:`umup_space`, which fixes
``sigma`` at 1 (under unit scaling the init scale lives in the forward
multipliers, so sweeping it is an error).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# axis declaration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HPAxis:
    """One named hyperparameter axis (a row of the paper's Table 1)."""

    name: str
    default: Any
    category: str                       # Table-1 grouping (documentation)
    doc: str = ""
    transferable: bool = True           # muTransfers (Table 1) vs retune
    engine: str = "runtime"             # "runtime" | "shared" | "external"
    dest: Optional[str] = None          # transfer() target: model|optim|schedule
    dest_key: Optional[str] = None      # key inside dest (default: name)
    search: Optional[Tuple[Any, ...]] = None  # default proxy-sweep candidates
    fixed: bool = False                 # pinned at default for this space

    def replace(self, **kw) -> "HPAxis":
        return dataclasses.replace(self, **kw)


def _log2_grid(lo: float, hi: float, step: float = 1.0, scale: float = 1.0):
    return tuple(scale * 2.0**z for z in np.arange(lo, hi, step))


# The HP axis universe (App. F.1/F.3 search grids, Table 1 taxonomy).
# Field order here IS the HParams field order — keep it stable.
HP_AXES: Tuple[HPAxis, ...] = (
    HPAxis(
        "lr", 1e-2, "optimization", doc="master (Adam/SGD) learning rate",
        engine="runtime", dest="optim", search=_log2_grid(-3, 3.5, 0.5, 5e-3),
    ),
    HPAxis(
        "sigma", 1.0, "initialization", doc="base init std scale (Table 2)",
        engine="runtime", dest="model", search=_log2_grid(-3, 3),
    ),
    HPAxis(
        "alpha_output", 1.0, "multiplier", doc="readout logit multiplier",
        engine="runtime", dest="model", search=_log2_grid(-4, 5, 2),
    ),
    HPAxis(
        "alpha_attn", 1.0, "multiplier", doc="attention logit multiplier",
        engine="runtime", dest="model", search=_log2_grid(-2, 5, 2),
    ),
    HPAxis(
        "alpha_embed", 1.0, "multiplier",
        doc="embedding multiplier (GPT-3 sweep, App. F.4)",
        engine="runtime", dest="model", search=(1.0, 3.16, 10.0),
    ),
    HPAxis(
        "lr_embed", None, "per-layer lr",
        doc="embedding learning rate (App. D.7); None = follow lr",
        engine="runtime", dest="optim",
    ),
    HPAxis(
        "schedule", "constant", "optimization", doc="LR schedule shape",
        engine="external", dest="schedule", dest_key="name",
    ),
    HPAxis(
        "warmup_steps", 0, "optimization", engine="external", dest="schedule",
    ),
    HPAxis("b1", 0.9, "optimization", engine="shared", dest="optim"),
    HPAxis("b2", 0.999, "optimization", engine="shared", dest="optim"),
    HPAxis(
        "momentum", 0.0, "optimization", doc="SGD momentum",
        engine="shared", dest="optim",
    ),
    # NOT muTransferable (Table 1) — kept as axes so callers see them
    # rejected/warned explicitly instead of silently dropped.
    HPAxis(
        "weight_decay", 0.0, "regularization", transferable=False,
        engine="external",
    ),
    HPAxis(
        "dropout", 0.0, "regularization", transferable=False,
        engine="external",
    ),
)


def _make_hparams_cls(axes: Sequence[HPAxis]):
    """Generate the frozen HParams dataclass from the axis universe."""

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    cls = dataclasses.make_dataclass(
        "HParams",
        [
            (a.name, Any, dataclasses.field(default=a.default))
            for a in axes
        ],
        frozen=True,
        namespace={
            "replace": _replace,
            "__doc__": (
                "The muTransferable HP bundle swept in tuning (Table 2 set).\n\n"
                "Generated from repro_torch.core.hpspace.HP_AXES — one field per\n"
                "axis; see HPSpace for taxonomy/engine semantics."
            ),
        },
    )
    cls.__module__ = __name__
    return cls


HParams = _make_hparams_cls(HP_AXES)


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------


class HPSpace:
    """An ordered set of :class:`HPAxis` with validation and the transfer
    plan."""

    def __init__(self, name: str, axes: Sequence[HPAxis] = HP_AXES):
        self.name = name
        self.axes: Dict[str, HPAxis] = {a.name: a for a in axes}

    # -- introspection -----------------------------------------------------
    def axis(self, name: str) -> HPAxis:
        try:
            return self.axes[name]
        except KeyError:
            raise KeyError(
                f"unknown HP axis {name!r}; {self.name} space has "
                f"{sorted(self.axes)}"
            ) from None

    def transferable_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes.values() if a.transferable)

    def not_transferable_names(self) -> Tuple[str, ...]:
        return tuple(
            a.name for a in self.axes.values() if not a.transferable
        )

    # -- derivation --------------------------------------------------------
    def replace_axes(self, *axes: HPAxis) -> "HPSpace":
        merged = dict(self.axes)
        for a in axes:
            merged[a.name] = a
        return HPSpace(self.name, tuple(merged.values()))

    def fix(self, name: str, **extra) -> "HPSpace":
        """A copy with ``name`` pinned at its default (removed from sweeps)."""
        return self.replace_axes(
            self.axis(name).replace(search=None, fixed=True, **extra)
        )

    # -- validation --------------------------------------------------------
    def validate(
        self, candidates: Sequence["HParams"], context: str = "sweep"
    ) -> None:
        """Reject candidates that move a fixed axis off its default."""
        for a in self.axes.values():
            if not a.fixed:
                continue
            bad = {
                getattr(h, a.name) for h in candidates
            } - {a.default}
            if bad:
                raise ValueError(
                    f"{context}: HP axis {a.name!r} is fixed at "
                    f"{a.default!r} in the {self.name} space (got "
                    f"{sorted(map(str, bad))}); it is not a tunable axis of "
                    f"this parametrization"
                )

    # -- transfer plan -----------------------------------------------------
    def transfer_plan(self, hps: "HParams") -> Dict[str, Dict[str, Any]]:
        """The zero-shot copy (Algorithm 1 step 3), grouped by destination."""
        plan: Dict[str, Dict[str, Any]] = {"model": {}, "optim": {}, "schedule": {}}
        for a in self.axes.values():
            if a.dest is None or not a.transferable:
                continue
            plan[a.dest][a.dest_key or a.name] = getattr(hps, a.name)
        return plan


@functools.lru_cache(maxsize=None)
def mup_space() -> HPSpace:
    """The µP/SP/NTK HP space: every Table-2 axis is sweepable."""
    return HPSpace("mup")


@functools.lru_cache(maxsize=None)
def umup_space() -> HPSpace:
    """u-µP's HP space: ``sigma`` is fixed at 1 (unit-scaled init — the
    scale lives in the forward multipliers), everything else as µP."""
    sp = mup_space().fix(
        "sigma",
        doc="fixed at 1 under u-µP: weights init at unit std and the scale "
            "moves into the forward multipliers",
    )
    sp.name = "umup"
    return sp
