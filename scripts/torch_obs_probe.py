#!/usr/bin/env python3
"""What observability costs on the card: the serving engines with and
without ``ServeObs``, and mup-gpt's train step with and without telemetry.

    python3 scripts/torch_obs_probe.py [--pairs 4] [--ballast 0]

Serving: smollm-135m at the width ``chip_smoke.py`` serves it (its
``SERVE_DEPTH`` layers, random weights from seed 0), the serve_dynamic
workload through ``DynamicEngine`` (16 requests over 4 system prompts,
chunks of 64, prefix cache on) and the serve phase's through ``Engine`` (8
requests), each serve on a fresh engine.  ``--pairs`` pairs a variant, in
turns: without obs first in even pairs, with obs first in odd ones.  Each
serve prints its wall (host clock around ``serve``, which ends in a
read-back), the host time the Python garbage collector ran inside it
(``gc.callbacks``) and its collections by generation.  ``--ballast N``
then keeps N small dicts alive (a long-running process's heap, as
``chip_smoke.py`` builds by its ``obs`` phase) and runs the pairs again.

Training: mup-gpt at full width (8 x 512 tokens, f32, AdamW), the plain
step and the telemetry step from one init, alternating for ``--pairs``
pairs after a warm-up each: CUDA-event time of each step's call and the
host time to its loss read-back.  Then the telemetry's reductions alone
over the step's params and updates (``obs.telemetry.update_ratios``) and
two other spellings of mean |x| over the same tensors, each timed with
CUDA events over 20 calls.

Prints one line per measurement and a last JSON line with every number;
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


class GcClock:
    """Host seconds the garbage collector runs, and its collections by
    generation, since reset()."""

    def __init__(self):
        self._t = None
        self.seconds, self.by_gen = 0.0, [0, 0, 0]
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.by_gen[info["generation"]] += 1
            self._t = None

    def reset(self):
        self.seconds, self.by_gen = 0.0, [0, 0, 0]


def serve_pairs(args, gcc, label):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.obs import ServeObs, Tracer
    from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig

    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False,
                                            n_layers=cs.SERVE_DEPTH)
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    kw = dict(n_slots=4, page_size=16, max_prompt_len=256, max_gen_len=64)
    dprompts, dlens = cs.shared_prefix_workload(cfg.vocab_size, 16, 256, seed=2)
    rng = np.random.default_rng(0)
    slens = rng.integers(64, 257, 8)
    sprompts = rng.integers(0, cfg.vocab_size, (8, 256))
    variants = {
        "dynamic": (lambda o: DynamicEngine(model, EngineConfig(prefill_chunk=64,
                                                               prefix_cache=True, **kw),
                                            obs=o), dprompts, dlens),
        "static": (lambda o: Engine(model, EngineConfig(**kw), obs=o), sprompts, slens),
    }
    out = {}
    for name, (make, prompts, lens) in variants.items():
        make(None).serve(params, prompts[:2], lens[:2])          # warm-up
        runs = {"plain": [], "obs": []}
        for i in range(args.pairs):
            for side in (("plain", "obs") if i % 2 == 0 else ("obs", "plain")):
                obs = ServeObs(tracer=Tracer()) if side == "obs" else None
                engine = make(obs)
                torch.cuda.synchronize()
                gcc.reset()
                t0 = time.perf_counter()
                res = engine.serve(params, prompts, lens)
                wall = time.perf_counter() - t0
                n_tok = int(res["lengths"].sum())
                runs[side].append(dict(wall_s=wall, tok_per_s=n_tok / wall,
                                       gc_s=gcc.seconds, gc_by_gen=list(gcc.by_gen)))
                print(f"[obs-probe] {label} {name} {side:5s} pair {i}: {wall:.3f} s, "
                      f"{n_tok / wall:.1f} tok/s, gc {gcc.seconds * 1e3:.1f} ms "
                      f"(collections by generation {gcc.by_gen})", flush=True)
        med = {s: float(np.median([r["wall_s"] for r in v])) for s, v in runs.items()}
        q = np.percentile([r["wall_s"] for r in runs["plain"]], [25, 75])
        print(f"[obs-probe] {label} {name}: median wall with obs {med['obs']:.3f} s, without "
              f"{med['plain']:.3f} s ({med['obs'] / med['plain'] - 1:+.2%}); the plain runs' "
              f"quartiles {q[0]:.3f}-{q[1]:.3f} s", flush=True)
        out[name] = dict(runs=runs, median_wall_s=med)
    return out


def train_pairs(args):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.coord_check import _coord_size
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.obs.telemetry import to_host, update_ratios
    from repro_torch.optim.optimizer import Optimizer

    cfg = get_config("mup-gpt").replace(dtype="float32")
    model = Model(cfg, device="cuda")
    opt = Optimizer.create("adamw", 1e-2, model.p13n, model.meta)
    params = model.init(seed=0)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             make_pipeline(cfg.vocab_size, 512, 8, seed=0).batch(0).items()}
    steps = {"plain": make_train_step(model, opt),
             "telemetry": make_train_step(model, opt, telemetry=True)}
    for step in steps.values():                                   # warm-up
        float(step(params, state, batch)[2]["loss"])
    runs = {k: [] for k in steps}
    for i in range(2 * args.pairs):
        for side in (("plain", "telemetry") if i % 2 == 0 else ("telemetry", "plain")):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            _, _, metrics = steps[side](params, state, batch)
            end.record()
            float(metrics["loss"])
            host = time.perf_counter() - t0
            if side == "telemetry":
                to_host(metrics["obs"])
            runs[side].append(dict(device_ms=start.elapsed_time(end), host_ms=host * 1e3))
    med = {k: {m: float(np.median([r[m] for r in v])) for m in ("device_ms", "host_ms")}
           for k, v in runs.items()}
    print(f"[obs-probe] train step (median of {2 * args.pairs}): telemetry "
          f"{med['telemetry']['device_ms']:.2f} ms on the card, {med['telemetry']['host_ms']:.2f} "
          f"ms to the loss; plain {med['plain']['device_ms']:.2f} / {med['plain']['host_ms']:.2f} "
          f"({med['telemetry']['device_ms'] / med['plain']['device_ms'] - 1:+.2%} on the card)",
          flush=True)

    upd = {k: v * 1e-3 for k, v in params.items()}

    def timed(fn, n=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    n_bytes = 2 * 4 * sum(p.numel() for p in params.values())
    spellings = {
        "update_ratios (mean(abs(x)))": lambda: update_ratios(upd, params),
        "mean(abs(x)) alone": lambda: [_coord_size(t) for d in (upd, params) for t in d.values()],
        "vector_norm(x, 1) / numel": lambda: [torch.linalg.vector_norm(t, 1) / t.numel()
                                              for d in (upd, params) for t in d.values()],
    }
    red = {}
    for name, fn in spellings.items():
        red[name] = timed(fn)
        print(f"[obs-probe] {name} over params and updates ({n_bytes / 1e9:.3f} GB): "
              f"{red[name]:.3f} ms ({n_bytes / red[name] / 1e6:.0f} GB/s of the inputs)",
              flush=True)
    return dict(runs=runs, median=med, reductions_ms=red, reduction_input_bytes=n_bytes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--ballast", type=int, default=0,
                    help="small dicts kept alive before a second round of serve pairs")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_obs_probe: needs a CUDA device")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    build.wait()
    gcc = GcClock()
    out = {"serve": serve_pairs(args, gcc, "fresh")}
    if args.ballast:
        ballast = [{"i": i} for i in range(args.ballast)]
        out["serve_ballast"] = serve_pairs(args, gcc, f"ballast {len(ballast)}")
    out["train"] = train_pairs(args)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
