"""Serving CLI: the continuous-batching engines and the dense-loop driver
on the card.

The port's counterpart of ``python -m repro.launch.serve``, with the same
flags and printout.  By default the dynamic engine (host-side page
allocator, radix-tree prefix caching with ``--prefix-cache``, chunked
prefill with ``--prefill-chunk``, pool size with ``--pool-pages``);
``--static`` selects the static engine (fixed page tables).  ``--kv-dtype
int8`` stores the paged KV pools as int8 with per-page-per-head scales, on
either engine.  ``--draft-width W`` serves speculatively with the target's
µP proxy of width W as the drafter (``--draft-k`` drafts an iteration;
``--adaptive-draft`` on the dynamic engine adapts that length per slot).
gemma2 (``--arch gemma2-2b``, ``gemma2-27b``) serves its sliding-window
layers from rings of pages on both engines; ``--prefix-cache`` there runs
with sharing off, as in the reference (ring pages are overwritten in
place).  The MoE configs (``--arch mixtral-8x22b``, whose every layer is
windowed, and ``llama4-scout-17b-a16e``) serve through the same engines,
their FFNs through models/moe.py.  ``--obs`` attaches a ``ServeObs``
(metrics and a phase tracer, host-side only: the same tokens, launches and
syncs) and prints the trace's event count and the metrics as Prometheus
text after the serve.  ``--dense`` serves through the dense-loop driver
(``generate``: a prefill, then one ``Model.decode_step`` a token over a
dense per-request cache; the engines' correctness oracle), and the CLI
falls back to it, saying so, for a pattern the paged engines cannot serve
(mamba2-130m's ``ssd`` blocks, recurrentgemma-9b's ``recurrent`` ones and
their tail); under it ``--mixed-lens``,
``--draft-width`` and ``--top-k/--top-p`` are ignored with a message, as in
the reference.  ``--mesh`` (not ported yet) exits with an error saying so,
and so does a model whose float32 weights do not fit the card (gemma2-27b,
mixtral-8x22b's 56 layers: bf16 weights or several cards are not ported
yet).

Usage:
    python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 8 --prompt-len 128 --gen-len 32 --slots 4
    python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --prefix-cache --prefill-chunk 16
    python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --kv-dtype int8
    python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --draft-width 0.25 --draft-k 4 --adaptive-draft
    python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --prefix-cache --prefill-chunk 16 --obs
    python -m repro_torch.launch.serve --arch gemma2-2b --prompt-len 6400 \
        --prefill-chunk 256 --gen-len 64
    python -m repro_torch.launch.serve --arch gemma2-27b --smoke --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke --device cpu
    python -m repro_torch.launch.serve --arch mamba2-130m --smoke --device cpu
    python -m repro_torch.launch.serve --arch gemma2-2b --smoke --device cpu --dense
    python -m repro_torch.launch.serve --arch mamba2-130m --prompt-len 512 --gen-len 256
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --requests 4 \
        --prompt-len 1920 --gen-len 256
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import build_model
from repro_torch.obs import ServeObs, Tracer
from repro_torch.serving import sampling
from repro_torch.serving.engine import _TAG_SAMPLE, DynamicEngine, Engine, EngineConfig
from repro_torch.serving.kv_cache import SERVABLE_KINDS, kv_dtype_of, pool_bytes


def weight_bytes(model) -> int:
    """Bytes of the model's float32 weights, from its parameter metas."""
    return 4 * sum(math.prod(m.infshape.shape) for m in model.flat_meta.values())


@torch.no_grad()
def generate(model, params, prompts, gen_len: int, temperature: float = 0.0,
             seed: int = 0, eos_token_id=None) -> torch.Tensor:
    """Dense-loop driver: prompts (B, P) -> generated tokens (B, gen_len)
    int32, on the model's device.

    A prefill with a cache of P + gen_len positions, then one
    ``decode_step`` a token (the dispatch overhead the engines exist to
    remove).  Stops early once every row has emitted the stop token
    (``eos_token_id``, default the config's knob; -1 disables); rows that
    finish first are padded with the stop token.  With a temperature each
    draw is a pure function of (seed, input position, row), by the
    engines' counter-based hash (serving/sampling.py), so a row draws what
    an engine's request of the same index draws from the same logits;
    torch cannot replay the reference's ``jax.random`` keys.  The reference's
    ``memory_inputs`` (encoder-decoder, VLM) are not ported.
    """
    dev = model.device
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, P = prompts.shape
    eos = model.cfg.eos_token_id if eos_token_id is None else int(eos_token_id)
    rows = torch.arange(B, device=dev)
    temp = torch.full((B,), float(temperature), device=dev)
    no_k = torch.zeros((B,), dtype=torch.int32, device=dev)
    no_p = torch.ones((B,), device=dev)

    def sample(logits, pos):
        if temperature == 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        keys = sampling.event_key(seed, pos, rows, _TAG_SAMPLE, dev)
        return sampling.sample(logits, temp, no_k, no_p, keys)

    last_logits, cache = model.prefill(params, prompts, cache_len=P + gen_len)
    tok = sample(last_logits, P - 1)[:, None]                     # (B, 1)
    done = (tok[:, 0] == eos) if eos >= 0 else torch.zeros(B, dtype=torch.bool,
                                                            device=dev)
    out = [tok]
    for i in range(gen_len - 1):
        if eos >= 0 and bool(done.all()):
            break
        pos = torch.full((B, 1), P + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, tok, pos, cache)
        tok = sample(logits[:, 0], P + i)[:, None]
        if eos >= 0:
            tok = torch.where(done[:, None], eos, tok)
            done = done | (tok[:, 0] == eos)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if toks.shape[1] < gen_len:  # early stop: pad with the stop token
        pad = torch.full((B, gen_len - toks.shape[1]), eos, dtype=torch.int32,
                         device=dev)
        toks = torch.cat([toks, pad], dim=1)
    return toks


def _servable(cfg) -> bool:
    return all(k in SERVABLE_KINDS for k in (*cfg.pattern, *cfg.tail))


def _count_generated(toks, eos: int) -> int:
    """Real generated tokens in a dense ``generate`` output: everything up
    to and including each row's first stop token -- the EOS padding after an
    early stop is not generation (the engines' ``lengths`` count the same
    way, so the two drivers' tok/s are comparable)."""
    toks = toks.cpu().numpy()
    if eos < 0:
        return toks.size
    hit = toks == eos
    first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, toks.shape[1])
    return int(first.sum())


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
                    help="speculative decoding: drafter width as a fraction "
                         "of the target (builds the µP proxy via "
                         "cfg.scaled; 0 disables speculation)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative draft length per verify (with "
                         "--draft-width)")
    ap.add_argument("--draft-min-d-head", type=int, default=8,
                    help="d_head floor for the drafter proxy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="the static engine (fixed page tables) instead of "
                         "the dynamic one")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prompt-prefix page sharing")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: tokens per chunk (a multiple of "
                         "--page-size); 0 = one-shot")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="global page-pool size override (dynamic engine)")
    ap.add_argument("--kv-dtype", default="",
                    choices=["", "int8", "bfloat16", "float32"],
                    help="paged KV pool dtype; int8 stores per-page-per-head "
                         "scaled pages, dequantized in the decode kernels "
                         "(~2x the pages per byte of bfloat16)")
    ap.add_argument("--adaptive-draft", action="store_true",
                    help="adapt per-slot draft length from measured "
                         "acceptance (dynamic engine + --draft-width)")
    ap.add_argument("--dense", action="store_true",
                    help="force the dense per-token-loop driver")
    ap.add_argument("--mixed-lens", action="store_true",
                    help="random per-request prompt lengths")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="multi-device serving (not ported yet)")
    ap.add_argument("--obs", action="store_true",
                    help="attach serving metrics and the phase tracer; "
                         "print the Prometheus text after the serve")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    if args.mesh is not None:
        ap.error("--mesh is not ported yet in the PyTorch port")
    if args.static and (args.prefix_cache or args.prefill_chunk
                        or args.adaptive_draft
                        or args.pool_pages is not None):
        ap.error("--prefix-cache/--prefill-chunk/--pool-pages/"
                 "--adaptive-draft need the dynamic engine (drop --static)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype="float32", kv_dtype=args.kv_dtype)
    use_engine = not args.dense and _servable(cfg)
    if not args.dense and not use_engine:
        print(f"[serve] {cfg.name}: pattern {cfg.pattern} not paged-servable "
              f"yet; falling back to the dense-loop driver")
    speculate = use_engine and args.draft_width > 0
    if args.adaptive_draft and not speculate:
        ap.error("--adaptive-draft needs a drafter (set --draft-width)")
    model = build_model(cfg, device=args.device)
    if model.device.type == "cuda":
        need = weight_bytes(model)
        have = torch.cuda.get_device_properties(model.device).total_memory
        if need > have:
            ap.error(f"{cfg.name}'s float32 weights need {need / 1e9:.1f} GB and "
                     f"the card has {have / 1e9:.1f} GB: serving it needs bf16 "
                     f"weights or several cards, not ported yet (ROADMAP.md § A 5)")
    params = model.init(args.seed)
    dev = model.device

    R, P = args.requests, args.prompt_len
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (R, P), generator=gen, device=dev)
    # default workload: every prompt at full width
    lens = torch.full((R,), P, dtype=torch.int64)
    if args.mixed_lens:
        if not use_engine:
            print("[serve] --mixed-lens ignored: the dense driver pads all "
                  "prompts to --prompt-len")
        else:
            gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
            lens = torch.randint(max(1, P // 4), P + 1, (R,), generator=gen,
                                 device=dev).cpu()
    draft_model = draft_params = None
    if args.draft_width > 0 and not use_engine:
        print("[serve] --draft-width ignored: speculation needs the paged "
              "engine")
    if speculate:
        # the narrow proxy shares the target's µP base shape (and its
        # kv_dtype): a distribution-matched drafter by construction
        dcfg = cfg.scaled(args.draft_width, min_d_head=args.draft_min_d_head)
        draft_model = build_model(dcfg, device=args.device)
        draft_params = draft_model.init(args.seed + 7)
        print(f"[serve] drafter {dcfg.name}: d_model {dcfg.d_model}, "
              f"{dcfg.n_heads} heads, draft_k={args.draft_k}")

    obs = ServeObs(tracer=Tracer()) if args.obs else None
    t0 = time.time()
    if use_engine:
        toks, n_tok = _serve_engine(args, cfg, model, params, prompts, lens,
                                    draft_model, draft_params, obs)
    else:
        if args.top_k or args.top_p < 1.0:
            print("[serve] --top-k/--top-p ignored: the dense driver "
                  "samples with temperature only")
        toks = generate(model, params, prompts, args.gen_len,
                        temperature=args.temperature, seed=args.seed,
                        eos_token_id=args.eos)
        eos = cfg.eos_token_id if args.eos is None else args.eos
        n_tok = _count_generated(toks, eos)   # its copy to the host waits for the card
    dt = time.time() - t0
    mode = "engine" if use_engine else "dense"
    print(f"[serve:{mode}] generated {tuple(toks.shape)} ({n_tok} tokens) "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s) on {dev}")
    print(toks[:, :16])
    if obs is not None:
        print(f"[obs] {len(obs.tracer.events)} trace events")
        print(obs.metrics.to_prometheus(), end="")
    return toks


def _serve_engine(args, cfg, model, params, prompts, lens, draft_model,
                  draft_params, obs):
    """One serve through the dynamic (or, with --static, the static) engine;
    returns (tokens, generated count)."""
    R, P = args.requests, args.prompt_len
    speculate = draft_model is not None
    ecfg = EngineConfig(
        n_slots=args.slots, page_size=args.page_size,
        max_prompt_len=P, max_gen_len=args.gen_len, eos_token_id=args.eos,
        draft_k=args.draft_k if speculate else 0,
        prefix_cache=args.prefix_cache, prefill_chunk=args.prefill_chunk,
        n_pages=args.pool_pages, adaptive_draft=args.adaptive_draft,
    )
    cls = Engine if args.static else DynamicEngine
    engine = cls(model, ecfg, draft_model=draft_model, obs=obs)
    n_global = getattr(engine, "n_pages", None)
    spec = engine.spec
    print(f"[serve] paged KV pools ({kv_dtype_of(cfg)}): "
          f"{pool_bytes(cfg, spec)/2**20:.1f} MiB "
          f"({spec.n_slots} slots x {spec.gp_cols} global"
          + (f" + {spec.wp_cols} ring (window {cfg.window_size})"
             if spec.wp_cols else "")
          + f" pages of {spec.page_size} tokens"
          + (f"; dynamic pool of {n_global}" if n_global else "")
          + ")")
    out = engine.serve(
        params, prompts.cpu().numpy(), lens.numpy(),
        temperature=torch.full((R,), args.temperature),
        top_k=torch.full((R,), args.top_k, dtype=torch.int32),
        top_p=torch.full((R,), args.top_p),
        seed=args.seed,
        draft_params=draft_params,
    )
    toks, n_tok = out["tokens"], int(out["lengths"].sum())
    if speculate:
        prop = max(1, out["proposed"])
        print(f"[serve] speculation: {out['accepted']}/{prop} drafts accepted "
              f"({out['accepted'] / prop:.1%}) over {out['steps']} engine "
              f"iterations")
    if "prefill_cached" in out and out["prefill_total"]:
        print(f"[serve] prefix cache: {out['prefill_cached']}/"
              f"{out['prefill_total']} prompt tokens served from shared pages "
              f"({out['prefill_cached']/out['prefill_total']:.1%})")
    return toks, n_tok


if __name__ == "__main__":
    main()
