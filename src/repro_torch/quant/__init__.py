"""Low-precision subsystem of the port: the mixed-precision policy and its
policy-routed matmuls (bf16; int8 and the int8 KV pools come later).

``cfg.amp`` resolves through :func:`policy_of` into a :class:`QuantPolicy`
that routes the flash-attention tile matmuls (``kernels/ops.attention``)
and the readout logit matmul (``models/model.py``).
"""
from repro_torch.quant.core import kernel_dot, quant_matmul
from repro_torch.quant.policy import QuantPolicy, policy_of

__all__ = ["QuantPolicy", "kernel_dot", "policy_of", "quant_matmul"]
