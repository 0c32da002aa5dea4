#!/usr/bin/env python3
"""Where mamba2-130m's f32 chunked forward drifts from float64 on the card.

    python3 scripts/torch_ssd_drift_probe.py [--out chiprun_out/ssd_drift.json]

The workload of ``chip_smoke.py``'s serve_mamba2: mamba2-130m at full
width, f32 weights from seed 0 (``Model.init`` on the card), 8 prompts of
512 tokens and 256 tokens generated greedily through the dense-loop driver
with the kernels.  Over those 768 tokens, the logits at rows 511-766 of
one chunked forward in f32 -- through the plain versions and through the
kernels -- against the same forward in float64, with the model cut to its
first 1, 6, 12, 18 and 24 layers; each distance over max |logit|, also by
row and at a few positions; at 12 and 24 layers the f32 forward of rows
0-1 on the machine's CPU too.  Prints the card's name and power limit, one
line a depth, and writes the JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DEPTHS = (1, 6, 12, 18, 24)
POSITIONS = (0, 1, 2, 8, 64, 128, 200, 255)   # of the 256 rows compared


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ssd_drift.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_ssd_drift_probe: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    cfg = get_config("mamba2-130m").replace(dtype="float32", eos_token_id=-1)
    params = Model(cfg, device="cuda", impl="auto").init(seed=0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 512))
    with torch.no_grad():
        gen = generate(Model(cfg, device="cuda", impl="auto"), params,
                       torch.as_tensor(prompts, device="cuda"), 256, eos_token_id=-1)
    seq = torch.cat([torch.as_tensor(prompts, device="cuda"), gen.long()], dim=1)
    rows = torch.arange(511, 767, device="cuda")
    out = {"distinct_generated_tokens_a_row": [len(set(r)) for r in gen.cpu().tolist()]}
    for k in DEPTHS:
        ck = cfg.replace(n_layers=k)
        pk = {n: (v[:k] if n.startswith("groups.") else v) for n, v in params.items()}
        with torch.no_grad():
            l64 = Model(ck.replace(dtype="float64"), device="cuda", impl="ref").forward(
                {n: v.double() for n, v in pk.items()}, seq, readout=rows)[0]
            plain = Model(ck, device="cuda", impl="ref").forward(pk, seq, readout=rows)[0]
            kern = Model(ck, device="cuda", impl="auto").forward(pk, seq, readout=rows)[0]
        s = l64.abs().max().item()
        d = (plain.double() - l64).abs()
        rec = dict(scale=s, plain=d.max().item() / s,
                   kernels=(kern.double() - l64).abs().max().item() / s,
                   by_row=[d[i].max().item() / s for i in range(d.shape[0])],
                   by_position={j: d[:, j].max().item() / s for j in POSITIONS})
        if k in (12, 24):
            with torch.no_grad():
                cpu = Model(ck, device="cpu", impl="ref").forward(
                    {n: v.cpu() for n, v in pk.items()}, seq[:2].cpu(),
                    readout=rows.cpu())[0].double()
            rec["rows_0_1_cpu"] = (cpu - l64[:2].cpu()).abs().max().item() / s
            rec["rows_0_1_card"] = d[:2].max().item() / s
        out[f"layers_{k}"] = rec
        print(f"[drift] {k} layers: " + json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
