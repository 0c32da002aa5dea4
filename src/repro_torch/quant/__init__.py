"""Low-precision subsystem of the port: the mixed-precision policy and its
policy-routed matmuls (bf16; the int8 matmul mode comes later), the int8
quantize/dequantize primitives, and the per-page-per-head scales of the
int8 paged KV pools (``quant/kv.py``).

``cfg.amp`` resolves through :func:`policy_of` into a :class:`QuantPolicy`
that routes the flash-attention tile matmuls (``kernels/ops.attention``)
and the readout logit matmul (``models/model.py``).  ``cfg.kv_dtype ==
"int8"`` selects the int8 pools (``serving/kv_cache.py``), which the
paged decode kernels dequantize as they stage each page.
"""
from repro_torch.quant.core import (
    INT8_MAX,
    dequantize_int8,
    kernel_dot,
    quant_matmul,
    quantize_int8,
)
from repro_torch.quant.kv import abs_scale, pack_kv, quantize_with, unpack_kv
from repro_torch.quant.policy import QuantPolicy, policy_of

__all__ = [
    "INT8_MAX",
    "QuantPolicy",
    "abs_scale",
    "dequantize_int8",
    "kernel_dot",
    "pack_kv",
    "policy_of",
    "quant_matmul",
    "quantize_int8",
    "quantize_with",
    "unpack_kv",
]
