#!/usr/bin/env python3
"""Serve throughput of the PyTorch port, compared across source trees on one GPU.

    python3 scripts/torch_serve_ab.py --trees OLD . . OLD [--repeats 3]

Each tree (a checkout holding ``src/repro_torch``) runs in a process of its
own, in the order given, so that two versions of the port alternate on the
same card.  Every process builds that tree's CUDA kernels, serves once to
warm up, then times ``--repeats`` serves of the workload of
``chip_smoke.py``'s serve phase: smollm-135m at full width, float32, random
weights from seed 0 (``zero_init_query=False``), 8 requests with prompts of
64-256 tokens and 64 generated tokens each, 4 slots, page 16, greedy.  The
host clock runs around ``Engine.serve``, which ends in a device-to-host copy.

Prints one JSON line per process (tree, walls, tok/s, a digest of the
greedy tokens; with ``--profile N`` also the N Python functions with the
most own host time in one more serve under cProfile) and, last, a summary with the median tok/s of each tree and
whether all trees produced the same tokens.  Exits non-zero if they did not.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

R, SLOTS, PMAX, GMAX, PAGE = 8, 4, 256, 64, 16


def one(tree: Path, repeats: int, profile: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, PMAX + 1, R)
    prompts = rng.integers(0, cfg.vocab_size, (R, PMAX))
    model = Model(cfg, device="cuda", impl="auto")
    params = model.init(seed=0)
    Engine(model, EngineConfig(n_slots=2, page_size=PAGE, max_prompt_len=PMAX,
                               max_gen_len=2)).serve(params, prompts[:1], lens[:1])
    engine = Engine(model, EngineConfig(n_slots=SLOTS, page_size=PAGE,
                                        max_prompt_len=PMAX, max_gen_len=GMAX))
    walls, digests, n_tok = [], set(), 0
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.serve(params, prompts, lens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        n_tok = int(out["lengths"].sum())
        digests.add(hashlib.sha256(out["tokens"].cpu().numpy().tobytes()).hexdigest())
    res = dict(tree=str(tree), walls_s=walls, tokens=n_tok, steps=out["steps"],
               tok_per_s=[n_tok / w for w in walls], tokens_sha256=sorted(digests))
    if profile:
        import cProfile
        import pstats
        prof = cProfile.Profile()
        prof.enable()
        engine.serve(params, prompts, lens)
        torch.cuda.synchronize()
        prof.disable()
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:profile]
        res["profile"] = dict(
            calls=sum(v[1] for v in stats.values()),
            top=[(f"{Path(f).name}:{line}:{name}", v[1], round(v[2] * 1e3, 3))
                 for (f, line, name), v in top])   # (function, calls, own ms)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(Path(args.one).resolve(), args.repeats, args.profile)),
              flush=True)
        return
    if not args.trees:
        ap.error("--trees is required")
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_serve_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    runs = []
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, __file__, "--one", str(Path(tree).resolve()),
             "--repeats", str(args.repeats), "--profile", str(args.profile)],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            sys.exit(f"torch_serve_ab: the run of {tree} failed")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).extend(r["tok_per_s"])
    digests = {d for r in runs for d in r["tokens_sha256"]}
    summary = {t: {"median_tok_per_s": sorted(v)[len(v) // 2], "tok_per_s": v}
               for t, v in by_tree.items()}
    print(json.dumps({"summary": summary, "same_tokens": len(digests) == 1}))
    if len(digests) != 1:
        sys.exit("torch_serve_ab: the trees' greedy tokens differ")


if __name__ == "__main__":
    main()
