"""abc-parametrizations (Definition A.2) as an open, extensible registry.

The port's copy of ``repro.core.parametrization``.  A *parametrization* is a
rule mapping each parameter tensor (classified by its InfShape into
input-like / hidden / output-like / scalar-like, Appendix B) to

    a) a forward multiplier,
    b) an initialization standard deviation,
    c) a per-tensor learning-rate factor (separately for SGD-like and
       Adam-like optimizers), and
    d) a weight-decay factor.

All width dependence is expressed through the *width multiplier*
``n_tilde = fan / base_fan`` so that every rule reduces to SP at the base
model shape (Eq. (4)).

Rules are instances of :class:`AbcParametrization` looked up by name in a
registry; config strings (``cfg.parametrization = "mup"``) resolve through
:func:`resolve`.  Built-ins: ``sp``, ``mup`` (Table 8), ``mup_table3``,
``mup_table9``, ``ntk`` and ``umup`` (unit-scaled µP).  Each rule owns the
HP space it sweeps (:meth:`AbcParametrization.hp_space`, core/hpspace.py).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Iterator, Optional, Tuple, Union

from repro_torch.core import hpspace as hpspace_lib
from repro_torch.core.infshape import InfShape


class Role(str, enum.Enum):
    """Appendix B classification.

    INPUT:  maps a finite dim to a width dim (embeddings, first projections)
            — includes all biases and norm gains.
    HIDDEN: width -> width (matrix-like).
    OUTPUT: width -> finite (readout / unembedding).
    SCALAR: no width dims.
    """

    INPUT = "input"
    HIDDEN = "hidden"
    OUTPUT = "output"
    SCALAR = "scalar"


def infer_role(infshape: InfShape) -> Role:
    fi, fo = infshape.fan_in_is_width(), infshape.fan_out_is_width()
    if fi and fo:
        return Role.HIDDEN
    if fo:
        return Role.INPUT
    if fi:
        return Role.OUTPUT
    return Role.SCALAR


@dataclasses.dataclass(frozen=True)
class AbcRule:
    """Resolved (multiplier, init std, lr mults, wd mult) for one tensor."""

    multiplier: float      # forward parameter multiplier (Definition A.1)
    init_std: float        # absolute std for initialization
    sgd_lr_mult: float     # per-tensor LR factor under SGD(+momentum)
    adam_lr_mult: float    # per-tensor LR factor under Adam-like optimizers
    wd_mult: float = 1.0   # weight-decay factor

    def lr_mult(self, adam_like: bool) -> float:
        return self.adam_lr_mult if adam_like else self.sgd_lr_mult


class AbcParametrization(str):
    """Base class for registrable abc-parametrization rules.

    Instances are ``str`` subclasses whose value is the registry name:
    hashable, comparable with plain strings, usable as config values.
    Subclasses implement :meth:`rule` and may override
    :meth:`attention_scale`, :meth:`hp_space` and :meth:`validate_config`.
    ``is_mup`` marks the µP-class rules (1/d attention, scaled Adam eps).
    """

    is_mup: bool = False
    aliases: Tuple[str, ...] = ()

    def __new__(cls, name: str):
        return super().__new__(cls, name)

    def rule(
        self,
        infshape: InfShape,
        role: Optional[Role] = None,
        sigma: float = 1.0,
        init_scale: float = 1.0,
        owns_scale: bool = True,
    ) -> AbcRule:
        """The abc-rule for one tensor.

        sigma: the tunable base init scale (Table 2).  init_scale: the static
        per-tensor sigma factor from ParamMeta.  owns_scale: True when the
        forward pass honors this tensor's ``multiplier`` and the tensor owns
        its init scale; False for raw-applied tensors (gains) and views of
        tied tensors (the readout view of the embedding), which unit-scaling
        rules must leave on the canonical µP rule.
        """
        raise NotImplementedError

    def attention_scale(self, d_head: int, base_d_head: int, alpha_attn=1.0):
        """Attention logit scale (Definition 4.1 + App. B.1).

        muP-class rules: ``alpha_attn * sqrt(base_d_head) / d_head``
        (== alpha_attn / sqrt(d_head) at the base shape).  SP/NTK:
        alpha_attn / sqrt(d_head).
        """
        if self.is_mup:
            return alpha_attn * math.sqrt(base_d_head) / d_head
        return alpha_attn / math.sqrt(d_head)

    def hp_space(self) -> hpspace_lib.HPSpace:
        """The muTransferable HP space this rule sweeps (see core.hpspace)."""
        return hpspace_lib.mup_space()

    def validate_config(self, cfg) -> None:
        """Raise if a ModelConfig is incompatible with this rule."""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, AbcParametrization] = {}


def register(
    p: AbcParametrization, *, overwrite: bool = False
) -> AbcParametrization:
    """Register a parametrization under its name (+ aliases)."""
    if not isinstance(p, AbcParametrization):
        raise TypeError(
            f"register() takes an AbcParametrization instance, got {type(p)}"
        )
    keys = (str(p), *p.aliases)
    for key in keys:
        if key in _REGISTRY and not overwrite:
            raise ValueError(
                f"parametrization {key!r} is already registered "
                f"(pass overwrite=True to replace it)"
            )
    for key in keys:
        _REGISTRY[key] = p
    return p


def get_parametrization(name: str) -> AbcParametrization:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown parametrization {name!r}; registered: "
            f"{sorted(_REGISTRY)}"
        ) from None


def available_parametrizations() -> Tuple[AbcParametrization, ...]:
    """All registered rules, in registration order (aliases once)."""
    return tuple(dict.fromkeys(_REGISTRY.values()))


def resolve(
    parametrization: Union[str, AbcParametrization]
) -> AbcParametrization:
    """Name or instance -> registered instance."""
    if isinstance(parametrization, AbcParametrization):
        return parametrization
    return get_parametrization(str(parametrization))


# ---------------------------------------------------------------------------
# built-in rules
# ---------------------------------------------------------------------------


class StandardParametrization(AbcParametrization):
    """SP: multiplier 1, init sigma/sqrt(fan_in), LR factor 1."""

    def rule(self, infshape, role=None, sigma=1.0, init_scale=1.0,
             owns_scale=True):
        role = role or infer_role(infshape)
        sigma = sigma * init_scale
        if role == Role.SCALAR:
            return AbcRule(1.0, sigma, 1.0, 1.0, 1.0)
        fan_in = max(infshape.fan_in, 1)
        return AbcRule(1.0, sigma / math.sqrt(fan_in), 1.0, 1.0, 1.0)


class NTKParametrization(AbcParametrization):
    """Kernel-regime reference: SP init, LR scaled down by width for
    width-fan-in tensors (footnote 4 / Sec. 10.4)."""

    def rule(self, infshape, role=None, sigma=1.0, init_scale=1.0,
             owns_scale=True):
        role = role or infer_role(infshape)
        sigma = sigma * init_scale
        if role == Role.SCALAR:
            return AbcRule(1.0, sigma, 1.0, 1.0, 1.0)
        fan_in = max(infshape.fan_in, 1)
        lr = 1.0 / infshape.width_mult if role in (Role.HIDDEN, Role.OUTPUT) else 1.0
        return AbcRule(1.0, sigma / math.sqrt(fan_in), lr, lr, 1.0)


class MuPTable8(AbcParametrization):
    """muP, Table 8 formulation (safe for tied input/output embeddings)."""

    is_mup = True

    def rule(self, infshape, role=None, sigma=1.0, init_scale=1.0,
             owns_scale=True):
        role = role or infer_role(infshape)
        sigma = sigma * init_scale
        if role == Role.SCALAR:
            return AbcRule(1.0, sigma, 1.0, 1.0, 1.0)
        fan_in = max(infshape.fan_in, 1)
        nt_in = infshape.width_mult
        nt_out = infshape.fan_out_mult
        if role == Role.INPUT:
            return AbcRule(
                multiplier=1.0,
                init_std=sigma / math.sqrt(fan_in),
                sgd_lr_mult=nt_out,
                adam_lr_mult=1.0,
            )
        if role == Role.HIDDEN:
            return AbcRule(
                multiplier=1.0,
                init_std=sigma / math.sqrt(fan_in),
                sgd_lr_mult=1.0,
                adam_lr_mult=1.0 / nt_in,
            )
        # OUTPUT: init var constant in width (== SP at base), forward
        # multiplier 1/nt_in, SGD LR * nt_in  (Table 8 with base factors)
        return AbcRule(
            multiplier=1.0 / nt_in,
            init_std=sigma / math.sqrt(infshape.base_fan_in),
            sgd_lr_mult=nt_in,
            adam_lr_mult=1.0,
        )


class MuPTable3(AbcParametrization):
    """muP, Table 3 formulation (output factor in the init, not the
    multiplier) — incompatible with tied embeddings."""

    is_mup = True

    def rule(self, infshape, role=None, sigma=1.0, init_scale=1.0,
             owns_scale=True):
        role = role or infer_role(infshape)
        sigma = sigma * init_scale
        if role == Role.SCALAR:
            return AbcRule(1.0, sigma, 1.0, 1.0, 1.0)
        fan_in = max(infshape.fan_in, 1)
        nt_in = infshape.width_mult
        nt_out = infshape.fan_out_mult
        if role == Role.INPUT:
            return AbcRule(1.0, sigma / math.sqrt(fan_in), nt_out, 1.0)
        if role == Role.HIDDEN:
            return AbcRule(1.0, sigma / math.sqrt(fan_in), 1.0, 1.0 / nt_in)
        return AbcRule(
            multiplier=1.0,
            init_std=sigma / math.sqrt(fan_in * nt_in),
            sgd_lr_mult=1.0 / nt_in,
            adam_lr_mult=1.0 / nt_in,
        )

    def validate_config(self, cfg) -> None:
        if getattr(cfg, "tie_embeddings", False):
            raise ValueError(
                "tied embeddings are incompatible with the Table-3 muP "
                "formulation; use 'mup' (Table 8) or 'mup_table9' (App. B)."
            )


class MuPTable9(AbcParametrization):
    """muP, Table 9 (Tensor Programs IV style) — Table 3 under Lemma J.1."""

    is_mup = True

    def rule(self, infshape, role=None, sigma=1.0, init_scale=1.0,
             owns_scale=True):
        role = role or infer_role(infshape)
        sigma = sigma * init_scale
        if role == Role.SCALAR:
            return AbcRule(1.0, sigma, 1.0, 1.0, 1.0)
        fan_in = max(infshape.fan_in, 1)
        nt_in = infshape.width_mult
        nt_out = infshape.fan_out_mult
        if role == Role.INPUT:
            return AbcRule(
                multiplier=math.sqrt(nt_out),
                init_std=sigma / math.sqrt(fan_in * nt_out),
                sgd_lr_mult=1.0,
                adam_lr_mult=1.0 / math.sqrt(nt_out),
            )
        if role == Role.HIDDEN:
            return AbcRule(1.0, sigma / math.sqrt(fan_in), 1.0, 1.0 / nt_in)
        return AbcRule(
            multiplier=1.0 / math.sqrt(nt_in),
            init_std=sigma / math.sqrt(fan_in),
            sgd_lr_mult=1.0,
            adam_lr_mult=1.0 / math.sqrt(nt_in),
        )


class UnitMuP(AbcParametrization):
    """u-µP — unit-scaled µP (Blake et al. 2024), anchored at the base shape.

    Every tensor that owns its scale gets the Lemma J.1 rescaling of Table 8
    with ``theta = table8_init_std``: weights initialize at std 1, the init
    scale moves into the forward multiplier, and the LR factors are
    compensated, so the trajectory is identical to Table 8 µP.  Raw-applied
    tensors and tied-tensor views keep the Table 8 rule.  ``sigma`` is fixed
    at 1.
    """

    is_mup = True

    def rule(self, infshape, role=None, sigma=1.0, init_scale=1.0,
             owns_scale=True):
        role = role or infer_role(infshape)
        base = _MUP.rule(infshape, role=role, sigma=float(sigma),
                         init_scale=init_scale)
        if not owns_scale or role == Role.SCALAR or base.init_std <= 0:
            return base
        theta = base.init_std
        return AbcRule(
            multiplier=base.multiplier * theta,
            init_std=1.0,
            sgd_lr_mult=base.sgd_lr_mult / (theta * theta),
            adam_lr_mult=base.adam_lr_mult / theta,
            wd_mult=base.wd_mult,
        )

    def hp_space(self) -> hpspace_lib.HPSpace:
        return hpspace_lib.umup_space()

    def validate_config(self, cfg) -> None:
        sigma = getattr(cfg, "sigma", 1.0)
        if sigma != 1.0:
            raise ValueError(
                f"u-µP fixes sigma at 1 (unit-scaled init; the scale lives "
                f"in the alpha multipliers) but the config has "
                f"sigma={sigma!r}; sweep alpha_* instead"
            )


SP = register(StandardParametrization("sp"))
_MUP = register(MuPTable8("mup"))
MUP = _MUP
MUP_TABLE3 = register(MuPTable3("mup_table3"))
MUP_TABLE9 = register(MuPTable9("mup_table9"))
NTK = register(NTKParametrization("ntk"))
UMUP = register(UnitMuP("umup"))


# ---------------------------------------------------------------------------
# deprecated enum-shaped shim
# ---------------------------------------------------------------------------


class _ParametrizationMeta(type):
    def __iter__(cls) -> Iterator[AbcParametrization]:
        return iter(available_parametrizations())


class Parametrization(metaclass=_ParametrizationMeta):
    """Deprecated shim for the old closed enum.

    ``Parametrization("mup")`` resolves through the registry;
    ``Parametrization.MUP`` etc. are the registered singletons;
    ``list(Parametrization)`` iterates every registered rule.  New code
    should use :func:`resolve` / :func:`register` directly.
    """

    SP = SP
    MUP = MUP
    MUP_TABLE3 = MUP_TABLE3
    MUP_TABLE9 = MUP_TABLE9
    NTK = NTK
    UMUP = UMUP

    def __new__(cls, name) -> AbcParametrization:
        return resolve(name)
