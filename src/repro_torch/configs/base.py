"""Config system: one frozen dataclass describing a model + its muP base shape.

The port's copy of ``repro.configs.base``, cut to the fields that the
decoder-only architectures the port serves and trains read: the
all-``attn`` ones, gemma2's ``("local", "attn")`` alternation with its
sliding window, query-chunked attention and post-norms, the MoE
blocks (``"moe"``, ``"local_moe"``) with untied embeddings, mamba2's
SSD blocks (``"ssd"``: the ``ssm_*`` and ``conv_width`` fields) and
recurrentgemma's RG-LRU blocks (``"recurrent"``: ``lru_width`` and
``conv_width``) with a non-repeating ``tail``.  Width
fields have parallel ``base_*`` fields: the muP base shape (Eq. 4).  By default
``base_* == *`` (pure SP compatibility at own width); `scaled(...)` derives
wider/narrower family members sharing the same base.

Fields of the reference left out, because nothing the port runs reads
them: the lowering and memory knobs of its JAX training (``remat``,
``scan_layers``, ``bf16_param_gather``, ``parallelism``, ``attn_acc``,
``use_pallas``, ``naive_loss``, ``use_qk_norm``) and the fields of block
kinds not ported yet (encoder-decoder, VLM).  A
reference config carries over by dropping them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer-block vocabulary used in `pattern` (one *group* that repeats).  The
# port runs:
#   "attn"        global self-attention + MLP
#   "local"       sliding-window self-attention + MLP (a ring of pages when
#                 served: serving/kv_cache.py)
#   "moe"         global self-attention + MoE FFN (models/moe.py)
#   "local_moe"   sliding-window self-attention + MoE FFN
#   "ssd"         Mamba-2 SSD mixer, no MLP (models/ssm.py; served by the
#                 dense-loop driver only)
#   "recurrent"   RG-LRU temporal-mixing block + MLP (models/rglru.py;
#                 served by the dense-loop driver only)
# Not ported yet: "cross" and "dec" (cross-attention).


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
    window_size: int = 4096           # for "local" blocks
    attn_chunk: int = 2048            # q-chunk size for long-seq attention
    attn_softcap: float = 0.0         # softcap on attention logits
    final_softcap: float = 0.0        # softcap on output logits
    rope_theta: float = 10000.0

    # ---- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # ---- SSM (mamba2) / RG-LRU (recurrentgemma) ---------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_n_heads: int = 0              # mamba2 heads (d_inner / head_dim)
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    lru_width: Optional[int] = None   # RG-LRU recurrence width (default d_model)

    # paged-KV pool storage dtype for serving; "" inherits `dtype`; "int8"
    # stores quantized pages + per-page-per-head f32 scales (quant/kv.py)
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
    zero_init_readout: bool = True    # App. D.2 (the untied readout)
    zero_init_query: bool = True      # App. D.2
    tie_embeddings: bool = True

    # ---- generation / serving ----------------------------------------------
    eos_token_id: int = -1            # stop token for generation; -1 disables

    # ---- misc architecture -------------------------------------------------
    act: str = "gelu_glu"             # "gelu" | "relu" | "gelu_glu" | "silu_glu"
    norm_eps: float = 1e-6
    post_attn_norm: bool = False      # gemma2 uses post-norms too
    dtype: str = "bfloat16"           # activation dtype
    max_seq_len: int = 8192

    def __post_init__(self):
        for f in ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff"):
            if getattr(self, f"base_{f}") is None:
                object.__setattr__(self, f"base_{f}", getattr(self, f))
        if self.kv_dtype not in ("", "int8", "bfloat16", "float32"):
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

    @property
    def d_inner(self) -> int:
        """SSD inner width."""
        return self.ssm_expand * self.d_model

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
            lru_width=None if self.lru_width is None else r(self.lru_width),
            name=f"{self.name}@{width_factor}x",
        )

    def proxy(self, width_factor: float = 0.25, min_d_head: int = 32) -> "ModelConfig":
        """The muTransfer proxy model (Algorithm 1, step 2)."""
        return self.scaled(width_factor, min_d_head=min_d_head)

    def hp_space(self):
        """The muTransferable HP space of this config's parametrization
        (per-rule: u-µP drops the sigma axis).  Resolved via the registry."""
        from repro_torch.core.parametrization import resolve  # lazy: avoid cycle

        return resolve(self.parametrization).hp_space()

    def as_base(self) -> "ModelConfig":
        """Re-anchor the muP base shape at this config's own widths."""
        return self.replace(
            base_d_model=self.d_model,
            base_n_heads=self.n_heads,
            base_n_kv_heads=self.n_kv_heads,
            base_d_head=self.d_head,
            base_d_ff=self.d_ff,
        )

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count N (for 6ND model-FLOPs accounting):
        the reference's formula, over the block kinds the port runs."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        blocks = list(self.pattern) * self.n_groups + list(self.tail)
        glu = self.act.endswith("_glu")
        mlp = d * f * (3 if glu else 2)
        attn = d * (self.n_heads * self.d_head) * 2 + d * (
            self.n_kv_heads * self.d_head
        ) * 2
        for b in blocks:
            if b in ("attn", "local"):
                total += attn + mlp
            elif b in ("moe", "local_moe"):
                total += attn + self.n_experts * mlp + d * self.n_experts
            elif b == "recurrent":
                # the reference's term: it leaves out w_a and w_x (2 w^2)
                w = self.lru_width or d
                total += 2 * d * w + w * d + 2 * w * (self.conv_width + 2) + mlp
            elif b == "ssd":
                di = self.d_inner
                nh = self.ssm_n_heads or di // self.ssm_head_dim
                total += d * (2 * di + 2 * self.ssm_state + nh) + di * d
                total += self.conv_width * (di + 2 * self.ssm_state)
            else:
                raise ValueError(b)
        return int(total)

    def active_param_count(self) -> int:
        """N_active for MoE (top_k of n_experts in MoE FFNs)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = d * f * (3 if self.act.endswith("_glu") else 2)
        n_moe = sum(
            1 for b in list(self.pattern) * self.n_groups + list(self.tail)
            if b.endswith("moe")
        )
        return int(self.param_count() - n_moe * (self.n_experts - self.top_k) * mlp)
