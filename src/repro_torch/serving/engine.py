"""Continuous-batching serving engine over a paged KV cache (static tables).

The port's counterpart of the reference's static ``Engine``
(``repro/serving/engine.py``).  Where the reference runs the whole serve in
one ``lax.while_loop`` under one jit, the port runs a host loop that keeps the
reference's exact order, so both produce the same tokens, lengths and step
count:

  - at most one admission per iteration, into the first free slot: a
    (1, max_prompt_len) prefill forward with the padding at position Pmax
    (invisible to real queries, dropped from the emitted cache), paged into
    the slot's rows, then the first token sampled;
  - then one (n_slots, 1) decode forward over all slots, inactive ones
    included at q_pos = -1 (their writes are dropped, their attention is
    zeros), sampling, and retirement on EOS or on the length budget.

Per iteration the host reads back only the sampled tokens (one small copy):
it owns the slot bookkeeping, so it needs them for EOS and for the output.
Sampling keys are a pure function of (seed, request, position) (see
serving/sampling.py).  ``DynamicEngine`` (page allocator, prefix cache,
chunked prefill) and speculative decoding come later.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.serving import kv_cache, sampling

_TAG_SAMPLE = 0   # committed-token sampling event tag (as in the reference)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4             # fixed decode batch size
    page_size: int = 16          # tokens per KV page
    max_prompt_len: int = 64     # prompt buffer length (prompts right-padded)
    max_gen_len: int = 16        # per-request generation budget
    eos_token_id: Optional[int] = None   # None -> model config's knob


class Engine:
    """Slot scheduler + host generation loop over a paged KV cache on the
    model's device."""

    def __init__(self, model, ecfg: EngineConfig = EngineConfig()):
        kv_cache.check_servable(model.cfg)
        if min(ecfg.n_slots, ecfg.page_size, ecfg.max_prompt_len,
               ecfg.max_gen_len) < 1:
            raise ValueError(f"engine dimensions must be >= 1, got {ecfg}")
        self.model = model
        self.ecfg = ecfg
        eos = model.cfg.eos_token_id if ecfg.eos_token_id is None else ecfg.eos_token_id
        self.eos = int(eos)
        self.spec = kv_cache.build_spec(
            model.cfg, ecfg.n_slots, ecfg.max_prompt_len + ecfg.max_gen_len,
            ecfg.page_size,
        )
        self.gtable = kv_cache.make_tables(self.spec, model.device)

    def _is_eos(self, tok: np.ndarray) -> np.ndarray:
        if self.eos < 0:
            return np.zeros_like(tok, bool)
        return tok == self.eos

    # ------------------------------------------------------------------
    def serve(
        self,
        params,
        prompts,                  # (R, L <= max_prompt_len) int
        prompt_lens,              # (R,) int true lengths
        *,
        temperature=None,         # (R,) float; <= 0 -> greedy
        top_k=None,               # (R,) int;  <= 0 -> off
        top_p=None,               # (R,) float; >= 1 -> off
        seed: int = 0,
    ) -> Dict[str, object]:
        """Serve R requests; returns {"tokens": (R, max_gen_len) int32,
        "lengths": (R,) int32} as CPU tensors and "steps": the loop-iteration
        count (generated tokens include the EOS, if hit)."""
        model, cfg, spec = self.model, self.model.cfg, self.spec
        dev = model.device
        S, P = spec.n_slots, spec.page_size
        Pmax, Gmax = self.ecfg.max_prompt_len, self.ecfg.max_gen_len
        prompts = np.asarray(prompts, np.int64)
        lens = np.asarray(prompt_lens, np.int64)
        R, L = prompts.shape
        if L > Pmax:
            raise ValueError(f"prompt buffer {L} > max_prompt_len {Pmax}")
        if lens.shape != (R,) or lens.min() < 1 or lens.max() > L:
            raise ValueError(f"prompt_lens must be (R,) in [1, {L}]")
        prompts_d = torch.zeros((R, Pmax), dtype=torch.int64, device=dev)
        prompts_d[:, :L] = torch.as_tensor(prompts, device=dev)
        t0, k0, p0 = sampling.default_params(R, dev)
        temp = t0 if temperature is None else torch.as_tensor(
            temperature, dtype=torch.float32, device=dev)
        topk = k0 if top_k is None else torch.as_tensor(
            top_k, dtype=torch.int32, device=dev)
        topp = p0 if top_p is None else torch.as_tensor(
            top_p, dtype=torch.float32, device=dev)

        # a batch of greedy requests needs no filtering and no random bits:
        # sample() returns the argmax for them
        all_greedy = bool((temp <= 0).all())

        def draw(rows, req, pos):
            """Tokens (n,) for logits rows (n, V) of requests ``req`` at
            input positions ``pos``."""
            if all_greedy:
                return rows.float().argmax(dim=-1)
            keys = sampling.event_key(seed, pos, req, _TAG_SAMPLE, dev)
            r = req.clamp(min=0)
            return sampling.sample(rows, temp[r], topk[r], topp[r], keys)

        pools = kv_cache.init_pools(cfg, spec, dev)
        active = np.zeros(S, bool)
        slot_req = np.full(S, -1, np.int64)
        slot_pos = np.zeros(S, np.int64)     # next write position
        slot_last = np.zeros(S, np.int64)    # last sampled token
        slot_ntok = np.zeros(S, np.int64)    # tokens emitted
        out_toks = np.zeros((R, Gmax), np.int32)
        out_len = np.zeros(R, np.int32)
        idx = torch.arange(Pmax, dtype=torch.int32, device=dev)
        # <= R admissions + <= R*Gmax token steps; the counter is a backstop
        # against a scheduling bug, as in the reference
        max_steps = R * (Gmax + 1) + S + 2
        step = next_req = 0

        while (next_req < R or active.any()) and step < max_steps:
            if next_req < R and not active.all():
                # ---------------- admission into the first free slot -------
                slot, req = int(np.argmin(active)), next_req
                plen = int(lens[req])
                positions = torch.where(idx < plen, idx, Pmax)[None]
                logits, pcache = model.forward(
                    params, prompts_d[req:req + 1], positions=positions,
                    mode="prefill", cache_len=Pmax,
                )
                kv_cache.admit_slot(
                    pools, pcache, cfg, spec, self.gtable[slot], plen
                )
                # first generated token: the event at input position plen - 1
                tok = int(draw(logits[:, plen - 1],
                               torch.tensor([req], device=dev), plen - 1)[0])
                active[slot] = not (self._is_eos(np.int64(tok)) or Gmax <= 1)
                slot_req[slot], slot_pos[slot] = req, plen
                slot_last[slot], slot_ntok[slot] = tok, 1
                out_toks[req, 0], out_len[req] = tok, 1
                next_req += 1

            # -------------------- one decode step over all slots ------------
            was_active = active.copy()
            positions = np.where(active, slot_pos, -1)
            paged = kv_cache.PagedState(
                global_table=self.gtable,
                active=torch.as_tensor(active, device=dev),
                page_size=P,
            )
            logits, pools = model.forward(
                params, torch.as_tensor(slot_last[:, None], device=dev),
                positions=torch.as_tensor(positions[:, None], dtype=torch.int32,
                                          device=dev),
                mode="decode", cache=pools, paged=paged,
            )
            tok = draw(logits[:, 0], torch.as_tensor(slot_req, device=dev),
                       torch.as_tensor(slot_pos, device=dev))
            tok = tok.cpu().numpy().astype(np.int64)
            # only active slots emit; inactive slots' draws are discarded
            rows = slot_req[was_active]
            ntok = slot_ntok + was_active
            out_toks[rows, slot_ntok[was_active]] = tok[was_active]
            out_len[rows] = ntok[was_active]
            finished = self._is_eos(tok) | (ntok >= Gmax)
            active = was_active & ~finished
            slot_pos = slot_pos + was_active
            slot_last = np.where(was_active, tok, slot_last)
            slot_ntok = np.where(was_active, ntok, slot_ntok)
            step += 1

        return {
            "tokens": torch.from_numpy(out_toks),
            "lengths": torch.from_numpy(out_len),
            "steps": step,
        }
