"""Config system: one frozen dataclass describing a model + its muP base shape.

The port's copy of ``repro.configs.base``, cut to the fields that the dense
all-``attn`` architectures read.  Width fields have parallel ``base_*``
fields: the muP base shape (Eq. 4).  By default ``base_* == *`` (pure SP
compatibility at own width); `scaled(...)` derives wider/narrower family
members sharing the same base.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer-block vocabulary used in `pattern` (one *group* that repeats).  The
# port serves "attn" (global self-attention + MLP); the other kinds of the
# reference ("local", "cross", "moe", "local_moe", "recurrent", "ssd") arrive
# with their blocks.


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # "lm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # repeating block pattern; len(pattern) * n_groups (+ len(tail)) == n_layers
    pattern: Tuple[str, ...] = ("attn",)
    tail: Tuple[str, ...] = ()

    # ---- muP base shape (defaults filled in __post_init__) --------------
    base_d_model: Optional[int] = None
    base_n_heads: Optional[int] = None
    base_n_kv_heads: Optional[int] = None
    base_d_head: Optional[int] = None
    base_d_ff: Optional[int] = None

    # ---- attention details ----------------------------------------------
    attn_softcap: float = 0.0         # softcap on attention logits
    final_softcap: float = 0.0        # softcap on output logits
    rope_theta: float = 10000.0

    # paged-KV pool storage dtype for serving; "" inherits `dtype`
    kv_dtype: str = ""
    # amp: mixed-precision matmul policy for the train step ("" = off,
    # "bf16", "int8"); resolved via quant.policy_of into a QuantPolicy that
    # routes the flash-attention tile matmuls and the readout logit matmul.
    # Master weights and optimizer state stay f32.
    amp: str = ""

    # ---- muP / HPs (the muTransferable set, Table 2) ----------------------
    parametrization: str = "mup"      # resolved via core.parametrization
    sigma: float = 1.0                # base init std scale
    alpha_output: float = 1.0
    alpha_attn: float = 1.0
    alpha_embed: float = 1.0          # embedding multiplier (App F.4)
    zero_init_query: bool = True      # App. D.2
    tie_embeddings: bool = True

    # ---- generation / serving ----------------------------------------------
    eos_token_id: int = -1            # stop token for generation; -1 disables

    # ---- misc architecture -------------------------------------------------
    act: str = "gelu_glu"             # "gelu" | "relu" | "gelu_glu" | "silu_glu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"           # activation dtype
    max_seq_len: int = 8192

    def __post_init__(self):
        for f in ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff"):
            if getattr(self, f"base_{f}") is None:
                object.__setattr__(self, f"base_{f}", getattr(self, f))
        if self.kv_dtype not in ("", "bfloat16", "float32"):
            raise ValueError(f"{self.name}: unknown kv_dtype {self.kv_dtype!r}")
        if self.amp not in ("", "bf16", "int8"):
            raise ValueError(f"{self.name}: unknown amp policy {self.amp!r}")
        ng, rem = divmod(self.n_layers - len(self.tail), max(len(self.pattern), 1))
        if rem != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} does not decompose into "
                f"pattern {self.pattern} x{ng} + tail {self.tail}"
            )

    # ------------------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def scaled(self, width_factor: float, min_d_head: int = 32) -> "ModelConfig":
        """A same-family model with widths scaled by `width_factor`, sharing
        this config's base shape — the muTransfer family operation.

        Keeps d_head >= min_d_head (App. D.4) by moving width into n_heads.
        """
        def r(x, q=1):
            return max(int(round(x * width_factor / q)) * q, q)

        d_model = r(self.d_model)
        d_head = max(r(self.d_head), min_d_head)
        n_heads = max(d_model // d_head, 1)
        # GQA needs n_kv | n_heads; shrink to the nearest divisor
        n_kv = max(min(self.n_kv_heads, n_heads), 1)
        while n_heads % n_kv:
            n_kv -= 1
        return self.replace(
            d_model=d_model,
            d_ff=r(self.d_ff),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_head,
            name=f"{self.name}@{width_factor}x",
        )

    def as_base(self) -> "ModelConfig":
        """Re-anchor the muP base shape at this config's own widths."""
        return self.replace(
            base_d_model=self.d_model,
            base_n_heads=self.n_heads,
            base_n_kv_heads=self.n_kv_heads,
            base_d_head=self.d_head,
            base_d_ff=self.d_ff,
        )
