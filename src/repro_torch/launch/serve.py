"""Serving CLI: the static continuous-batching engine on the card.

The port's counterpart of ``python -m repro.launch.serve``, with the same
flags and printout.  Flags of parts not ported yet (the dynamic engine's
prefix cache, chunked prefill and pool override, speculation, int8 KV, the
mesh, observability, the dense-loop driver) exit with an error saying so.

Usage:
    python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 8 --prompt-len 128 --gen-len 32 --slots 4
    python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import kv_dtype_of, pool_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos", type=int, default=None,
                    help="stop token id (default: config's eos_token_id)")
    ap.add_argument("--draft-width", type=float, default=0.0,
                    help="speculative decoding (not ported yet)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative draft length (with --draft-width)")
    ap.add_argument("--draft-min-d-head", type=int, default=8,
                    help="d_head floor for the drafter proxy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="the static engine (fixed page tables); the only "
                         "engine ported yet, so also the default")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prompt-prefix page sharing (not ported yet)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill (not ported yet)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="global page-pool size override (not ported yet)")
    ap.add_argument("--kv-dtype", default="",
                    choices=["", "int8", "bfloat16", "float32"],
                    help="paged KV pool dtype (int8: not ported yet)")
    ap.add_argument("--adaptive-draft", action="store_true",
                    help="adaptive draft length (not ported yet)")
    ap.add_argument("--dense", action="store_true",
                    help="the dense per-token-loop driver (not ported yet)")
    ap.add_argument("--mixed-lens", action="store_true",
                    help="random per-request prompt lengths")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="multi-device serving (not ported yet)")
    ap.add_argument("--obs", action="store_true",
                    help="serving metrics and phase trace (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    not_ported = {
        "--draft-width": args.draft_width > 0,
        "--prefix-cache": args.prefix_cache,
        "--prefill-chunk": args.prefill_chunk != 0,
        "--pool-pages": args.pool_pages is not None,
        "--kv-dtype int8": args.kv_dtype == "int8",
        "--adaptive-draft": args.adaptive_draft,
        "--dense": args.dense,
        "--mesh": args.mesh is not None,
        "--obs": args.obs,
    }
    for flag, used in not_ported.items():
        if used:
            ap.error(f"{flag} is not ported yet: the PyTorch port serves "
                     f"with the static engine only")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype="float32", kv_dtype=args.kv_dtype)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    dev = model.device

    R, P = args.requests, args.prompt_len
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (R, P), generator=gen, device=dev)
    # default workload: every prompt at full width
    lens = torch.full((R,), P, dtype=torch.int64)
    if args.mixed_lens:
        gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
        lens = torch.randint(max(1, P // 4), P + 1, (R,), generator=gen,
                             device=dev).cpu()

    t0 = time.time()
    ecfg = EngineConfig(
        n_slots=args.slots, page_size=args.page_size,
        max_prompt_len=P, max_gen_len=args.gen_len, eos_token_id=args.eos,
    )
    engine = Engine(model, ecfg)
    print(f"[serve] paged KV pools ({kv_dtype_of(cfg)}): "
          f"{pool_bytes(cfg, engine.spec)/2**20:.1f} MiB "
          f"({engine.spec.n_slots} slots x {engine.spec.gp_cols} global"
          f" pages of {engine.spec.page_size} tokens)")
    out = engine.serve(
        params, prompts.cpu().numpy(), lens.numpy(),
        temperature=torch.full((R,), args.temperature),
        top_k=torch.full((R,), args.top_k, dtype=torch.int32),
        top_p=torch.full((R,), args.top_p),
        seed=args.seed,
    )
    toks, n_tok = out["tokens"], int(out["lengths"].sum())
    dt = time.time() - t0
    print(f"[serve:engine] generated {tuple(toks.shape)} ({n_tok} tokens) "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s) on {dev}")
    print(toks[:, :16])
    return toks


if __name__ == "__main__":
    main()
