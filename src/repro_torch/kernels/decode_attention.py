"""Paged single-query flash decode: the wrapper of the hand-written CUDA kernel.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::_decode_kernel``
(``flash_decode``) for float32 and bfloat16 pools; the source and its design
note are ``csrc/decode_attention.cu``.  The wrapper launches the kernel on
CUDA tensors or raises; the plain version is
``kernels/ref.py::decode_attention_ref``, chosen by ``kernels/ops.py`` for
CPU tensors.  The int8-pool path and the multi-query kernel come later.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches in this process (reset by callers that count)


def flash_decode(
    q: torch.Tensor,            # (B, H, d) — one query per slot
    k_pages: torch.Tensor,      # (N, P, K, d) paged pool
    v_pages: torch.Tensor,      # (N, P, K, d)
    pos_pages: torch.Tensor,    # (N, P) int32; -1 = empty
    page_table: torch.Tensor,   # (B, C) int32 page ids
    q_pos: torch.Tensor,        # (B,) int32; -1 = inactive slot -> zeros out
    *,
    scale: float = 1.0,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Paged single-query flash attention; returns (B, H, d) in q's dtype.

    Query head h reads kv head h // G (kv-major GQA layout, G = H // K).
    Page ids are clamped to [0, N - 1]; rows with q_pos < 0 are zeros.
    """
    global launches
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages,
                   page_table=page_table, q_pos=q_pos)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"flash_decode kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode kernel needs contiguous {name}")
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(f"q must be (B, H, d) and pools (N, P, K, d), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, d = q.shape
    N, P, K, dk = k_pages.shape
    C = page_table.shape[-1]
    if 0 in (N, P, K, d) or v_pages.shape != k_pages.shape or dk != d or H % K:
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}"
        )
    if tuple(pos_pages.shape) != (N, P) or tuple(page_table.shape) != (B, C) \
            or tuple(q_pos.shape) != (B,):
        raise ValueError(
            f"pos {tuple(pos_pages.shape)}, table {tuple(page_table.shape)}, "
            f"q_pos {tuple(q_pos.shape)} do not fit B={B}, N={N}, P={P}"
        )
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in _DTYPE_CODES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"flash_decode kernel takes float32/bfloat16 q and "
                         f"pools, got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    for name in ("pos_pages", "page_table", "q_pos"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if k_pages.numel() >= 2**31 or B * H * d >= 2**31:
        raise ValueError("flash_decode kernel: sizes exceed int32 indexing")
    lib = build.library()
    smem = lib.repro_flash_decode_smem_bytes(H // K, d, P)
    if smem > 48 * 1024:
        raise ValueError(f"flash_decode kernel: G={H // K}, d={d}, P={P} needs "
                         f"{smem} bytes of shared memory (at most 49152)")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out.zero_()
    err = lib.repro_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), page_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, H, K, d, N, P, C, float(scale), int(window),
        float(softcap), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_decode kernel")
    launches += 1
    return out
