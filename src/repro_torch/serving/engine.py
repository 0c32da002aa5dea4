"""Continuous-batching serving engines over a paged KV cache.

The port's counterparts of the reference's ``Engine`` and ``DynamicEngine``
(``repro/serving/engine.py``).  Where the reference runs the static serve in
one ``lax.while_loop`` under one jit, and the dynamic one as a host loop
around one jitted step, the port runs both as host loops that keep the
reference's exact order, so each produces the reference's tokens, lengths
and step count.

:class:`Engine` (static page tables, interleaved across slots):

  - at most one admission per iteration, into the first free slot: a
    (1, max_prompt_len) prefill forward with the padding at position Pmax
    (invisible to real queries, dropped from the emitted cache), paged into
    the slot's rows, then the first token sampled;
  - then one (n_slots, 1) decode forward over all slots, inactive ones
    included at q_pos = -1 (their writes are dropped, their attention is
    zeros), sampling, and retirement on EOS or on the length budget.

:class:`DynamicEngine` (page tables from ``serving/allocator.py``): pages
are popped from a free list at admission, full prompt pages already
resident are shared through the radix-tree prefix cache (their prefill is
skipped), and long prompts prefill in ``prefill_chunk``-token pieces
interleaved with decode steps.  A chunk is a decode-mode forward of the
chunk's tokens at their absolute positions: written into the pages first,
then attended through the multi-query paged kernel.

Both engines pass the pool dicts whole, so int8 pools (``cfg.kv_dtype ==
"int8"``) need nothing here: ``serving/kv_cache.py`` keeps each page's
scales with its bytes through admission, invalidation, prefix sharing and
eviction, and the decode kernels read them.

Per iteration the host reads back only the sampled tokens (one small copy):
it owns the slot bookkeeping, so it needs them for EOS and for the output.
Sampling keys are a pure function of (seed, request, position) (see
serving/sampling.py), so admission timing, chunking and cache hits never
move a draw.  Speculative decoding comes later.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.serving import kv_cache, sampling
from repro_torch.serving.allocator import BlockManager

_TAG_SAMPLE = 0   # committed-token sampling event tag (as in the reference)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4             # fixed decode batch size
    page_size: int = 16          # tokens per KV page
    max_prompt_len: int = 64     # prompt buffer length (prompts right-padded)
    max_gen_len: int = 16        # per-request generation budget
    eos_token_id: Optional[int] = None   # None -> model config's knob
    draft_k: int = 0             # speculative draft length; 0 = off (not
    #                              ported yet)
    # --- DynamicEngine-only knobs (static Engine rejects them) ---
    prefix_cache: bool = False   # radix-tree prompt-prefix page sharing
    prefill_chunk: int = 0       # admit prompts in chunks of this many
    #                              tokens (page_size multiple); 0 = one-shot
    n_pages: Optional[int] = None        # global pool size override
    n_window_pages: Optional[int] = None  # window pool size override
    adaptive_draft: bool = False  # per-slot draft length (not ported yet)


class _Queue:
    """One serve()'s requests on the model's device: prompts padded to
    max_prompt_len, per-request sampling parameters, and the sampler."""

    def __init__(self, prompts, prompt_lens, Pmax, dev, temperature, top_k,
                 top_p, seed):
        prompts = np.asarray(prompts, np.int64)
        lens = np.asarray(prompt_lens, np.int64)
        R, L = prompts.shape
        if L > Pmax:
            raise ValueError(f"prompt buffer {L} > max_prompt_len {Pmax}")
        if lens.shape != (R,) or lens.min() < 1 or lens.max() > L:
            raise ValueError(f"prompt_lens must be (R,) in [1, {L}]")
        self.R, self.lens, self.seed, self.dev = R, lens, seed, dev
        self.prompts = np.zeros((R, Pmax), np.int64)
        self.prompts[:, :L] = prompts
        self.prompts_d = torch.as_tensor(self.prompts, device=dev)
        t0, k0, p0 = sampling.default_params(R, dev)
        self.temp = t0 if temperature is None else torch.as_tensor(
            temperature, dtype=torch.float32, device=dev)
        self.topk = k0 if top_k is None else torch.as_tensor(
            top_k, dtype=torch.int32, device=dev)
        self.topp = p0 if top_p is None else torch.as_tensor(
            top_p, dtype=torch.float32, device=dev)
        # a batch of greedy requests needs no filtering and no random bits:
        # sample() returns the argmax for them
        self.all_greedy = bool((self.temp <= 0).all())

    def draw(self, rows, req, pos):
        """Tokens (n,) for logits rows (n, V) of requests ``req`` at input
        positions ``pos``."""
        if self.all_greedy:
            return rows.float().argmax(dim=-1)
        keys = sampling.event_key(self.seed, pos, req, _TAG_SAMPLE, self.dev)
        r = req.clamp(min=0)
        return sampling.sample(rows, self.temp[r], self.topk[r], self.topp[r],
                               keys)


class _Slots:
    """Host-side slot state and the output buffers of one serve()."""

    def __init__(self, S, R, Gmax):
        self.active = np.zeros(S, bool)
        self.req = np.full(S, -1, np.int64)
        self.pos = np.zeros(S, np.int64)     # next write position
        self.last = np.zeros(S, np.int64)    # last sampled token
        self.ntok = np.zeros(S, np.int64)    # tokens emitted
        self.out_toks = np.zeros((R, Gmax), np.int32)
        self.out_len = np.zeros(R, np.int32)


class Engine:
    """Slot scheduler + host generation loop over a paged KV cache on the
    model's device, with static interleaved page tables."""

    def __init__(self, model, ecfg: EngineConfig = EngineConfig()):
        if ecfg.prefix_cache or ecfg.prefill_chunk or ecfg.adaptive_draft or (
            ecfg.n_pages is not None or ecfg.n_window_pages is not None
        ):
            raise ValueError(
                "prefix_cache / prefill_chunk / n_pages / n_window_pages / "
                "adaptive_draft need the dynamic engine — use DynamicEngine"
            )
        self._init_common(model, ecfg, lookahead=ecfg.draft_k)
        self.gtable = kv_cache.make_tables(self.spec, model.device)

    def _init_common(self, model, ecfg: EngineConfig, lookahead: int):
        """Validation + geometry shared by the static and dynamic engines."""
        kv_cache.check_servable(model.cfg)
        if min(ecfg.n_slots, ecfg.page_size, ecfg.max_prompt_len,
               ecfg.max_gen_len) < 1:
            raise ValueError(f"engine dimensions must be >= 1, got {ecfg}")
        if ecfg.draft_k > 0 or ecfg.adaptive_draft:
            raise ValueError(
                "speculative decoding (draft_k, adaptive_draft) is not "
                "ported yet"
            )
        self.model = model
        self.ecfg = ecfg
        eos = model.cfg.eos_token_id if ecfg.eos_token_id is None else ecfg.eos_token_id
        self.eos = int(eos)
        self.spec = kv_cache.build_spec(
            model.cfg, ecfg.n_slots, ecfg.max_prompt_len + ecfg.max_gen_len,
            ecfg.page_size, lookahead=lookahead,
        )

    def _is_eos(self, tok: np.ndarray) -> np.ndarray:
        if self.eos < 0:
            return np.zeros_like(tok, bool)
        return tok == self.eos

    # ------------------------------------------------------------------
    # step bodies, shared by both engines
    # ------------------------------------------------------------------

    def _start(self, q: _Queue, st: _Slots, slot: int, req: int, tok: int):
        """The first generated token of ``req`` (sampled at input position
        plen - 1) is out: the slot starts decoding, unless it is done."""
        plen = int(q.lens[req])
        st.active[slot] = not (self._is_eos(np.int64(tok)) or self.ecfg.max_gen_len <= 1)
        st.req[slot], st.pos[slot] = req, plen
        st.last[slot], st.ntok[slot] = tok, 1
        st.out_toks[req, 0], st.out_len[req] = tok, 1

    def _admit_full(self, params, q: _Queue, st: _Slots, pools, slot: int,
                    req: int, gtab_row: torch.Tensor):
        """One-shot admission: a full-prompt prefill forward, paged into the
        slot's pages, then the first token sampled."""
        dev, Pmax = self.model.device, self.ecfg.max_prompt_len
        plen = int(q.lens[req])
        idx = torch.arange(Pmax, dtype=torch.int32, device=dev)
        positions = torch.where(idx < plen, idx, Pmax)[None]
        logits, pcache = self.model.forward(
            params, q.prompts_d[req:req + 1], positions=positions,
            mode="prefill", cache_len=Pmax,
        )
        kv_cache.admit_slot(pools, pcache, self.model.cfg, self.spec,
                            gtab_row, plen)
        tok = q.draw(logits[:, plen - 1], torch.tensor([req], device=dev),
                     plen - 1)
        self._start(q, st, slot, req, int(tok[0]))

    def _decode(self, params, q: _Queue, st: _Slots, pools,
                gtable: torch.Tensor):
        """One (n_slots, 1) decode forward over all slots, sampling, and
        retirement on EOS or the length budget."""
        dev = self.model.device
        was_active = st.active.copy()
        positions = np.where(st.active, st.pos, -1)
        paged = kv_cache.PagedState(
            global_table=gtable, active=torch.as_tensor(st.active, device=dev),
            page_size=self.spec.page_size,
        )
        logits, _ = self.model.forward(
            params, torch.as_tensor(st.last[:, None], device=dev),
            positions=torch.as_tensor(positions[:, None], dtype=torch.int32,
                                      device=dev),
            mode="decode", cache=pools, paged=paged,
        )
        tok = q.draw(logits[:, 0], torch.as_tensor(st.req, device=dev),
                     torch.as_tensor(st.pos, device=dev))
        tok = tok.cpu().numpy().astype(np.int64)
        # only active slots emit; inactive slots' draws are discarded
        rows = st.req[was_active]
        ntok = st.ntok + was_active
        st.out_toks[rows, st.ntok[was_active]] = tok[was_active]
        st.out_len[rows] = ntok[was_active]
        finished = self._is_eos(tok) | (ntok >= self.ecfg.max_gen_len)
        st.active = was_active & ~finished
        st.pos = st.pos + was_active
        st.last = np.where(was_active, tok, st.last)
        st.ntok = np.where(was_active, ntok, st.ntok)

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
        S, Gmax = self.spec.n_slots, self.ecfg.max_gen_len
        q = _Queue(prompts, prompt_lens, self.ecfg.max_prompt_len,
                   self.model.device, temperature, top_k, top_p, seed)
        R = q.R
        pools = kv_cache.init_pools(self.model.cfg, self.spec, self.model.device)
        st = _Slots(S, R, Gmax)
        # <= R admissions + <= R*Gmax token steps; the counter is a backstop
        # against a scheduling bug, as in the reference
        max_steps = R * (Gmax + 1) + S + 2
        step = next_req = 0
        while (next_req < R or st.active.any()) and step < max_steps:
            if next_req < R and not st.active.all():
                slot = int(np.argmin(st.active))     # the first free slot
                self._admit_full(params, q, st, pools, slot, next_req,
                                 self.gtable[slot])
                next_req += 1
            self._decode(params, q, st, pools, self.gtable)
            step += 1
        return {
            "tokens": torch.from_numpy(st.out_toks),
            "lengths": torch.from_numpy(st.out_len),
            "steps": step,
        }


class DynamicEngine(Engine):
    """Host-scheduled engine over the dynamic page allocator + prefix cache.

    The host loop owns everything that varies per request — which physical
    pages back each slot (allocator.BlockManager free lists + refcounts),
    which prompt prefixes are already resident (radix-tree prefix cache:
    full shared pages map copy-free and skip prefill), when a request may
    be admitted (full page budget reserved up front; requests wait
    head-of-line until retirements free pages), and the chunk schedule for
    long prompts (``prefill_chunk``-token pieces on absolute boundaries,
    interleaved with decode steps).  Per iteration: at most one admission
    step in flight (a one-shot prefill, or the next chunk of the current
    admission), then one decode step over all slots if any is active.

    Determinism: sampling keys are (request, position)-folded, chunk
    boundaries sit on absolute multiples of ``prefill_chunk`` and shared
    spans are floored to the same boundaries, so with prefix caching on or
    off a greedy serve gives the same tokens.  Prefix sharing applies to
    global-attention pages (the only kind the port serves).

    KV pools and the prefix cache persist across ``serve()`` calls, so a
    later serve hits prefixes cached by an earlier one.
    """

    def __init__(self, model, ecfg: EngineConfig = EngineConfig()):
        C = ecfg.prefill_chunk
        if C < 0 or (C and C % ecfg.page_size):
            raise ValueError(
                f"prefill_chunk must be a multiple of page_size "
                f"({ecfg.page_size}), got {C}"
            )
        # chunk forwards write up to chunk_len - 1 positions ahead of their
        # earliest query (kv_cache.build_spec)
        self._init_common(model, ecfg,
                          lookahead=max(ecfg.draft_k, C - 1 if C else 0))
        spec = self.spec
        self.n_pages = ecfg.n_pages or spec.n_global_pages
        self.blocks = BlockManager(
            n_pages=self.n_pages, page_size=spec.page_size,
            gp_cols=spec.gp_cols, prefix_cache=ecfg.prefix_cache,
        )
        self._align = max(C // spec.page_size, 1)
        self._cmax = C if C else ecfg.max_prompt_len
        # host-side page tables, copied to the card when an admission
        # changes them
        self._gtab = np.zeros((spec.n_slots, spec.gp_cols), np.int32)
        self._gtab_d = torch.as_tensor(self._gtab, device=model.device)
        # pools persist across serve() calls: prefix-cached pages stay warm
        self._pools = kv_cache.init_pools(model.cfg, spec, model.device,
                                          n_global=self.n_pages)

    # ------------------------------------------------------------------
    def _admit_chunk(self, params, q: _Queue, st: _Slots, cur, s0: int,
                     l0: int, last: bool):
        """One prefill chunk of the current admission: a decode-mode forward
        of ``l0`` prompt tokens at positions s0.. (the rest of the fixed
        ``_cmax``-wide chunk at -1: masked everywhere, writes dropped; the
        fixed width, as in the reference, keeps a 1-token chunk on the
        multi-query path); on
        the last chunk, the first token sampled from the last chunk row,
        keyed exactly like the one-shot path — (plen - 1, req, SAMPLE)."""
        dev, Pmax = self.model.device, self.ecfg.max_prompt_len
        slot, req = cur["slot"], cur["req"]
        j = np.arange(self._cmax)
        idx = s0 + j
        toks = q.prompts_d[req, torch.as_tensor(np.clip(idx, 0, Pmax - 1),
                                                device=dev)][None]
        pos = torch.as_tensor(np.where(j < l0, idx, -1)[None],
                              dtype=torch.int32, device=dev)
        paged = kv_cache.PagedState(
            global_table=self._gtab_d[slot:slot + 1],
            active=torch.ones(1, dtype=torch.bool, device=dev),
            page_size=self.spec.page_size,
        )
        logits, _ = self.model.forward(
            params, toks, positions=pos, mode="decode", cache=self._pools,
            paged=paged,
        )
        if last:
            plen = cur["plen"]
            tok = q.draw(logits[:, max(l0 - 1, 0)],
                         torch.tensor([req], device=dev), plen - 1)
            self._start(q, st, slot, req, int(tok[0]))

    # ------------------------------------------------------------------
    def serve(
        self,
        params,
        prompts,                  # (R, L <= max_prompt_len) int
        prompt_lens,              # (R,) int true lengths
        *,
        temperature=None,
        top_k=None,
        top_p=None,
        seed: int = 0,
        arrivals=None,            # (R,) seconds from serve start, ascending
        record_times: bool = False,
    ) -> Dict[str, Any]:
        """Serve R requests (FIFO, optionally arrival-gated).

        Returns the static engine's dict plus ``prefill_cached`` /
        ``prefill_total`` (prompt tokens served from shared pages vs total)
        and, with ``record_times``, ``token_times`` (per request, the
        ``time.monotonic()`` stamp relative to serve start of each emitted
        token) and the ``arrivals`` vector.
        """
        spec, blocks = self.spec, self.blocks
        S, Gmax, C = spec.n_slots, self.ecfg.max_gen_len, self.ecfg.prefill_chunk
        Pmax = self.ecfg.max_prompt_len
        q = _Queue(prompts, prompt_lens, Pmax, self.model.device,
                   temperature, top_k, top_p, seed)
        R = q.R
        arr = (np.zeros((R,), np.float64) if arrivals is None
               else np.asarray(arrivals, np.float64))
        st = _Slots(S, R, Gmax)
        pending = list(range(R))
        free = list(range(S))
        occupied: Dict[int, int] = {}     # slot -> req (decoding, holds pages)
        cur = None                        # the one in-flight admission
        prefill_cached = prefill_total = 0
        token_times: list = [[] for _ in range(R)]
        prev_len = np.zeros((R,), np.int64)
        steps = 0
        chunks_bound = (Pmax // C + 2) if C else 2
        max_steps = R * (Gmax + chunks_bound + 2) + S + 8
        t0 = time.monotonic()

        while pending or cur is not None or occupied:
            now = time.monotonic() - t0
            # idle until the next arrival when nothing is running
            if (cur is None and not occupied and pending
                    and arr[pending[0]] > now):
                time.sleep(min(arr[pending[0]] - now, 2e-3))
                continue
            # ---- start a new admission (at most one in flight) ----
            if cur is None and pending and free and arr[pending[0]] <= now:
                req = pending[0]
                plen = int(q.lens[req])
                prompt = [int(x) for x in q.prompts[req, :plen]]
                slot = min(free)
                adm = blocks.try_admit(slot, prompt, align_pages=self._align)
                if adm is None:
                    # head-of-line wait: retirements will free pages
                    if not occupied:
                        raise RuntimeError(
                            f"admission stalled: request {req} needs pages "
                            "but no live request will ever free any"
                        )
                else:
                    pending.pop(0)
                    free.remove(slot)
                    self._gtab[slot, :] = adm.table_row
                    self._gtab_d = torch.as_tensor(self._gtab,
                                                   device=self.model.device)
                    c = adm.cached_len
                    prefill_cached += c
                    prefill_total += plen
                    if C:
                        chunks = [(s0, min(C, plen - s0))
                                  for s0 in range(c, plen, C)]
                    elif c:
                        chunks = [(c, plen - c)]   # one suffix chunk
                    else:
                        chunks = None              # one-shot prefill path
                    cur = {"req": req, "slot": slot, "plen": plen,
                           "prompt": prompt, "chunks": chunks, "i": 0,
                           "adm": adm}
            # ---- this step's admission work ----
            finishing = None
            if cur is not None:
                if cur["chunks"] is None:
                    self._admit_full(params, q, st, self._pools, cur["slot"],
                                     cur["req"], self._gtab_d[cur["slot"]])
                    finishing, cur = cur, None
                else:
                    s0, l0 = cur["chunks"][cur["i"]]
                    if cur["i"] == 0:
                        # freshly popped pages may hold a previous
                        # occupant's entries; shared pages are never reset
                        kv_cache.invalidate_pages(
                            self._pools, self.model.cfg, cur["adm"].fresh_pages)
                    last = cur["i"] == len(cur["chunks"]) - 1
                    self._admit_chunk(params, q, st, cur, s0, l0, last)
                    if last:
                        finishing, cur = cur, None
                    else:
                        cur["i"] += 1
            # ---- one decode step over all slots, if any is active ----
            if st.active.any():
                self._decode(params, q, st, self._pools, self._gtab_d)
            steps += 1
            tnow = time.monotonic() - t0
            # ---- host bookkeeping ----
            if finishing is not None:
                # prompt fully resident: publish its full pages to the
                # radix tree before any chance of retirement
                blocks.complete(finishing["slot"], finishing["prompt"])
                occupied[finishing["slot"]] = finishing["req"]
            new_len = st.out_len.astype(np.int64)
            for r in np.nonzero(new_len > prev_len)[0]:
                token_times[r].extend([tnow] * int(new_len[r] - prev_len[r]))
            prev_len = new_len
            for slot in sorted(occupied):
                if not st.active[slot]:
                    blocks.retire(slot)
                    del occupied[slot]
                    free.append(slot)
            if steps > max_steps:
                raise RuntimeError(
                    f"dynamic engine exceeded {max_steps} steps — "
                    "host scheduler bug"
                )

        out = {
            "tokens": torch.from_numpy(st.out_toks),
            "lengths": torch.from_numpy(st.out_len),
            "steps": steps,
            "prefill_cached": prefill_cached,
            "prefill_total": prefill_total,
        }
        if record_times:
            out["token_times"] = token_times
            out["arrivals"] = arr
        return out
