#!/usr/bin/env python3
"""Copy-task training of smollm-135m and its depth-1 µP proxy by learning
rate, on the card.

    python3 scripts/torch_copy_lr_probe.py [--lrs 1e-2,1e-3,3e-4,1e-4,3e-5]

For each Adam learning rate, trains the full-width target 100 steps and
``make_proxy(cfg, 0.125, depth=1, min_d_head=8)`` 150 steps on the copy task
(``repro_torch.data.copy_task``, batch 16 x seq 32, the recipe of the
reference's ``benchmarks/perf_serve.py``), prints every tenth (target) and
fifteenth (proxy) loss and the last, then serves 8 copy prompts of 8 tokens,
48 generated, on 4 slots with and without speculation at draft_k 6 through
the static engine and prints the acceptance, the iterations against the
plain engine's steps and whether the greedy tokens are equal.
``chip_smoke.py`` trains both at the rate this picks (``COPY_LR``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="1e-2,1e-3,3e-4,1e-4,3e-5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_copy_lr_probe: needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import make_proxy
    from repro_torch.data.copy_task import copy_batch, train_copy
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    build.wait()
    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False)
    pcfg = make_proxy(cfg, 0.125, depth=1, min_d_head=8)
    prompts = copy_batch(np.random.RandomState(2), cfg.vocab_size, 8, 8)
    lens = np.full(8, 8)
    kw = dict(n_slots=4, page_size=16, max_prompt_len=8, max_gen_len=48)
    for lr in (float(x) for x in args.lrs.split(",")):
        t0 = time.perf_counter()
        model, params, lt = train_copy(cfg, steps=100, seed=0, lr=lr)
        dmodel, dparams, ld = train_copy(pcfg, steps=150, seed=1, lr=lr)
        train_s = time.perf_counter() - t0
        base = Engine(model, EngineConfig(**kw)).serve(params, prompts, lens)
        spec = Engine(model, EngineConfig(**kw, draft_k=6), draft_model=dmodel).serve(
            params, prompts, lens, draft_params=dparams)
        print(f"lr {lr:g}: target losses {[round(x, 3) for x in lt[::10]]}, last "
              f"{lt[-1]:.4g}; proxy {[round(x, 3) for x in ld[::15]]}, last {ld[-1]:.4g}; "
              f"trained in {train_s:.1f} s; acceptance {spec['accepted']}/"
              f"{spec['proposed']}, {spec['steps']} iterations against {base['steps']} "
              f"steps, greedy tokens equal: {torch.equal(base['tokens'], spec['tokens'])}",
              flush=True)


if __name__ == "__main__":
    main()
