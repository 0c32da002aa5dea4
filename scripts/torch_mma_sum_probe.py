#!/usr/bin/env python3
"""How the tensor cores sum the products over d, seen through B5-B7.

    python3 scripts/torch_mma_sum_probe.py

On the GPU, prints the card's name and power limit, then for every case
of chip_smoke.py's FLASH_CASES, in the bf16 operand mode, the max and mean
error of the tensor-core kernels' o (B5), dq (B6) and dk, dv (B7) against
their plain versions (kernels/ref.py flash_fwd_ref, flash_bwd_ref), with
the plain versions' products over d (q·kᵀ, do·vᵀ; ``ref._d_dot``) summed
under each of these models of the kernels' mma.sync m16n8k16 chains:

- "f32 matmul": a float32 matmul of the bf16 operands (kernel_dot);
- "exact, nearest": the exact sum, rounded to nearest once;
- "16, nearest" / "16, toward zero": d in steps of 16, each step's 16
  products and the running f32 sum added exactly, then rounded to nearest
  or toward zero (the latter is ``ref._mma_dot``, the plain versions' own);
- "8, toward zero": the same in steps of 8.

The model that matches the hardware leaves only f32 summation error (the
other sums: p v, ds k, p^T do, ds^T q) and the odd operand that still
rounds to another bf16 value; the others leave more of those.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def steps(width, toward_zero):
    """d in steps of ``width``, each added exactly to the running f32 sum and
    rounded to nearest or toward zero."""
    from repro_torch.kernels import ref

    def dot(a, b):
        a = a.to(torch.bfloat16).double()
        b = b.to(torch.bfloat16).double()
        acc = None
        for c0 in range(0, a.shape[-1], width):
            x = a[..., c0:c0 + width] @ b[..., c0:c0 + width, :]
            x = x if acc is None else x + acc.double()
            acc = ref._round_toward_zero(x) if toward_zero else x.float()
        return acc
    return dot


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_mma_sum_probe: needs a CUDA device")
    import chip_smoke as cs
    from repro_torch import quant
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    policy = quant.QuantPolicy("bf16")
    models = {
        "f32 matmul": lambda a, b: ref.kernel_dot(a, b, policy),
        "exact, nearest": lambda a, b: (a.to(torch.bfloat16).double()
                                        @ b.to(torch.bfloat16).double()).float(),
        "16, nearest": steps(16, False),
        "16, toward zero": steps(16, True),
        "8, toward zero": steps(8, True),
    }
    own = ref._d_dot
    for i, case in enumerate(cs.FLASH_CASES):
        label, B, S, H, K, d, window, cap, scale, dt = case
        q, k, v, do = cs.flash_inputs(B, S, H, K, d, dt, i)
        qs = (q.float() * scale).to(dt)
        kw = dict(causal=True, window=window, softcap=cap, policy=policy)
        o, lse = fa.flash_fwd(qs, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        got = (o, fa.flash_bwd_dq(qs, k, v, do, lse, delta, **kw),
               *fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **kw))
        for name, model in models.items():
            ref._d_dot = lambda a, b, pol, _m=model: _m(a, b)
            try:
                want = (ref.flash_fwd_ref(qs, k, v, **kw)[0],
                        *ref.flash_bwd_ref(qs, k, v, do, lse, delta, **kw))
            finally:
                ref._d_dot = own
            errs = [cs.rounded_err(g, w) for g, w in zip(got, want)]
            print(f"[mma] {label:26s} {name:16s} " + "  ".join(
                f"{n} max {e[0]:.3g} mean {e[1]:.3g}"
                for n, e in zip(("o", "dq", "dk", "dv"), errs)), flush=True)
            del want
        del q, k, v, do, o, lse, delta, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
