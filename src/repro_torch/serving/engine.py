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

Sliding-window layers (gemma2's "local") keep their pages in rings of the
window table (``kv_cache.build_spec``: the window plus the lookahead a
chunk or a verify writes ahead, one page more), built with the global
table in every ``PagedState`` the engines make, the drafter's included;
``DynamicEngine`` pops ring pages from a window pool of their own and
shares none of them.

Both engines pass the pool dicts whole, so int8 pools (``cfg.kv_dtype ==
"int8"``) need nothing here: ``serving/kv_cache.py`` keeps each page's
scales with its bytes through admission, invalidation, prefix sharing and
eviction, and the decode kernels read them.

Per iteration the host reads back only the sampled tokens (one small copy):
it owns the slot bookkeeping, so it needs them for EOS and for the output.
Sampling keys are a pure function of (seed, request, position, event tag)
(see serving/sampling.py), so admission timing, chunking, cache hits and
accepted draft lengths never move a draw.

Speculative decoding (``EngineConfig.draft_k`` and a ``draft_model`` of the
target's vocabulary; here the natural drafter is the target's narrow µP
proxy, ``cfg.scaled`` or ``core.transfer.make_proxy``), in both engines.
The drafter has its own pools with static interleaved tables.  At admission
it prefills the prompt into them, and the slot's catch-up context becomes
the last ``draft_k`` prompt tokens and the first sampled one.  Then each
iteration, in place of the decode step (``_decode_spec``):

  - catch-up: a (S, dk+1) drafter forward of that context at positions
    pos - dk .. pos (B9), which repairs the holes a rejection left in the
    drafter's pages and gives the first draft's logits;
  - draft: dk single-token drafter forwards at pos + 1 + j (B8), each draw
    tagged DRAFT at pos + j;
  - verify: one (S, dk+1) target forward of [last, d_0 .. d_{dk-1}] at pos
    .. pos + dk (B9).  Its write is the rollback: it lands on whatever a
    rejection left ahead of the committed position before any committed
    query can see it;
  - accept: serving/sampling.spec_accept (ACCEPT-tagged uniforms at pos ..
    pos + dk - 1, SAMPLE-tagged residual or bonus draws), then the commit,
    cut at the first committed EOS and at the length budget.

The drafts stay on the card; the host reads back one (S, dk+2) block per
iteration (the drafts, the extra token and the accepted count).  Greedy
output is the target's, token for token; sampled output follows the
target's distribution.  ``DynamicEngine`` with ``adaptive_draft`` picks each
slot's draft length from an EMA of its acceptance (host control; the chain
is cut by the accept mask, zeroed drafter rows and positions at -1).

Observability (``obs``, an ``obs.ServeObs``) is host-side only: the
engines record counters, gauges and histograms into its registry and
spans into its tracer around the read-backs they already make, so with
obs attached every token, kernel launch and host sync is the same.  The
static engine wraps ``serve`` in one ``serve`` span (closed after the
loop's last read-back); the dynamic one records ``admission`` and
``retire`` events and a ``step`` span per iteration with its phase
(``prefill``, ``chunk_prefill``, ``decode`` or ``verify``), from the
loop's own ``time.monotonic()`` stamps.  A step that ends in no read-back
(a chunk that is neither the admission's last nor followed by a decode)
times its dispatch; the next read-back's step carries its device work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.serving import kv_cache, sampling
from repro_torch.serving.allocator import BlockManager

# sampling event tags, as in the reference: one stream per (request,
# position, event kind)
_TAG_SAMPLE = 0   # committed-token sampling (direct, residual, bonus)
_TAG_ACCEPT = 1   # speculative accept/reject uniform
_TAG_DRAFT = 2    # drafter proposal


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4             # fixed decode batch size
    page_size: int = 16          # tokens per KV page
    max_prompt_len: int = 64     # prompt buffer length (prompts right-padded)
    max_gen_len: int = 16        # per-request generation budget
    eos_token_id: Optional[int] = None   # None -> model config's knob
    draft_k: int = 0             # speculative draft length; 0 = off
    # --- DynamicEngine-only knobs (static Engine rejects them) ---
    prefix_cache: bool = False   # radix-tree prompt-prefix page sharing
    prefill_chunk: int = 0       # admit prompts in chunks of this many
    #                              tokens (page_size multiple); 0 = one-shot
    n_pages: Optional[int] = None        # global pool size override
    n_window_pages: Optional[int] = None  # window pool size override
    adaptive_draft: bool = False  # per-slot draft length from measured
    #                               acceptance (host control; needs draft_k)


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
        # sample() returns the argmax for them, and speculation's one-hot
        # distributions reduce to argmax comparisons
        self.all_greedy = bool((self.temp <= 0).all())

    def params(self, req):
        """(temperature, top_k, top_p) of requests ``req`` (-1: request 0's)."""
        r = req.clamp(min=0)
        return self.temp[r], self.topk[r], self.topp[r]

    def draw(self, rows, req, pos):
        """Tokens (n,) for logits rows (n, V) of requests ``req`` at input
        positions ``pos``."""
        if self.all_greedy:
            return rows.float().argmax(dim=-1)
        keys = sampling.event_key(self.seed, pos, req, _TAG_SAMPLE, self.dev)
        return sampling.sample(rows, *self.params(req), keys)

    def propose(self, rows, req, pos):
        """A draft token (n,) for drafter logits rows (n, V), drawn at input
        positions ``pos`` under the DRAFT tag, and its filtered distribution
        (None for an all-greedy queue, whose drafts are argmaxes)."""
        if self.all_greedy:
            return rows.float().argmax(dim=-1), None
        dist = sampling.filtered_dist(rows, *self.params(req))
        keys = sampling.event_key(self.seed, pos, req, _TAG_DRAFT, self.dev)
        return sampling.categorical_from(keys, dist), dist

    def accept(self, vlogits, drafts, q_dist, req, pos, jmask):
        """(n_acc, extra) of spec_accept for verify logits (S, k+1, V) at
        input positions pos .. pos + k and drafts (S, k) with their
        distributions ``q_dist``; ``jmask`` (S, k) cuts each chain (None:
        the whole chain).  Greedy queues compare argmaxes, which is what
        spec_accept does with one-hot p and q."""
        S, T, V = vlogits.shape
        k = T - 1
        if self.all_greedy:
            target = vlogits.float().argmax(dim=-1)
            hit = drafts == target[:, :k]
            if jmask is not None:
                hit &= jmask
            n_acc = hit.long().cumprod(dim=1).sum(dim=1)
            return n_acc, torch.gather(target, 1, n_acc[:, None])[:, 0]
        t, tk, tp = (x.repeat_interleave(T) for x in self.params(req))
        p_dist = sampling.filtered_dist(vlogits.reshape(S * T, V), t, tk, tp)
        if jmask is not None:
            # a forced stop's residual must be p itself (see spec_accept)
            q_dist = torch.where(jmask[..., None], q_dist, 0.0)
        grid = pos[:, None] + torch.arange(T, device=self.dev)
        akeys = sampling.event_key(self.seed, grid[:, :k], req[:, None],
                                   _TAG_ACCEPT, self.dev)
        skeys = sampling.event_key(self.seed, grid, req[:, None], _TAG_SAMPLE,
                                   self.dev)
        return sampling.spec_accept(p_dist.reshape(S, T, V), q_dist, drafts,
                                    akeys, skeys, accept_mask=jmask)


class _Slots:
    """Host-side slot state and the output buffers of one serve()."""

    def __init__(self, S, R, Gmax, dk=0):
        self.active = np.zeros(S, bool)
        self.req = np.full(S, -1, np.int64)
        self.pos = np.zeros(S, np.int64)     # next write position
        self.last = np.zeros(S, np.int64)    # last sampled token
        self.ntok = np.zeros(S, np.int64)    # tokens emitted
        self.out_toks = np.zeros((R, Gmax), np.int32)
        self.out_len = np.zeros(R, np.int32)
        # speculation: the last dk + 1 committed tokens per slot, ending at
        # pos (the drafter's catch-up chunk: one iteration commits at most
        # dk + 1, so it covers every hole a rejection can leave), the
        # drafts accepted and proposed, and the last iteration's per slot
        self.ctx = np.zeros((S, dk + 1), np.int64)
        self.accepted = self.proposed = 0
        self.last_acc = np.zeros(S, np.int64)
        self.last_prop = np.zeros(S, np.int64)


@dataclasses.dataclass
class _Draft:
    """The drafter's weights and paged pools in one serve()."""

    params: Dict[str, torch.Tensor]
    pools: Dict[str, Any]


class Engine:
    """Slot scheduler + host generation loop over a paged KV cache on the
    model's device, with static interleaved page tables.  Pass
    ``draft_model`` (the target's vocabulary, on its device; typically its
    µP proxy) with ``ecfg.draft_k >= 1`` for speculative decoding."""

    def __init__(self, model, ecfg: EngineConfig = EngineConfig(),
                 draft_model=None, obs=None):
        if ecfg.prefix_cache or ecfg.prefill_chunk or ecfg.adaptive_draft or (
            ecfg.n_pages is not None or ecfg.n_window_pages is not None
        ):
            raise ValueError(
                "prefix_cache / prefill_chunk / n_pages / n_window_pages / "
                "adaptive_draft need the dynamic engine — use DynamicEngine"
            )
        # speculative chunks write up to draft_k positions ahead of their
        # earliest query: the windowed ring covers window + draft_k before
        # it wraps (kv_cache.build_spec)
        self._init_common(model, ecfg, draft_model, lookahead=ecfg.draft_k)
        self.obs = obs
        self.gtable, self.wtable = kv_cache.make_tables(self.spec, model.device)

    def _init_common(self, model, ecfg: EngineConfig, draft_model,
                     lookahead: int):
        """Validation + geometry shared by the static and dynamic engines."""
        kv_cache.check_servable(model.cfg)
        if min(ecfg.n_slots, ecfg.page_size, ecfg.max_prompt_len,
               ecfg.max_gen_len) < 1:
            raise ValueError(f"engine dimensions must be >= 1, got {ecfg}")
        if (ecfg.draft_k > 0) != (draft_model is not None):
            raise ValueError(
                "speculative decoding needs both draft_k >= 1 and a "
                f"draft_model (got draft_k={ecfg.draft_k}, "
                f"draft_model={'set' if draft_model is not None else 'None'})"
            )
        self.model = model
        self.draft_model = draft_model
        self.ecfg = ecfg
        eos = model.cfg.eos_token_id if ecfg.eos_token_id is None else ecfg.eos_token_id
        self.eos = int(eos)
        max_total = ecfg.max_prompt_len + ecfg.max_gen_len
        self.spec = kv_cache.build_spec(
            model.cfg, ecfg.n_slots, max_total, ecfg.page_size,
            lookahead=lookahead,
        )
        if draft_model is None:
            return
        kv_cache.check_servable(draft_model.cfg)
        if draft_model.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(
                "drafter vocab must match the target "
                f"({draft_model.cfg.vocab_size} != {model.cfg.vocab_size})"
            )
        if draft_model.device != model.device:
            raise ValueError(f"drafter on {draft_model.device}, target on "
                             f"{model.device}")
        self.dspec = kv_cache.build_spec(
            draft_model.cfg, ecfg.n_slots, max_total, ecfg.page_size,
            lookahead=lookahead,
        )
        self.dgtable, self.dwtable = kv_cache.make_tables(self.dspec,
                                                          model.device)

    def _draft(self, draft_params, pools) -> Optional[_Draft]:
        """The serve()'s drafter state (None for a plain engine)."""
        if self.draft_model is None:
            return None
        if draft_params is None:
            raise ValueError("speculative engine: serve() needs draft_params")
        return _Draft(draft_params, pools)

    def _record_serve(self, *, duration, requests, tokens, steps,
                      accepted, proposed):
        """End-of-serve aggregate metrics (shared by both engines).  The
        reference's ``serve_compile_count`` gauge has no counterpart: the
        port compiles no serve program."""
        m = self.obs.metrics
        m.counter("serve_requests_total", "requests served").inc(requests)
        m.counter("serve_tokens_total", "tokens generated").inc(tokens)
        m.counter(
            "serve_steps_total", "engine loop iterations run"
        ).inc(steps)
        m.histogram(
            "serve_duration_seconds", "wall time per serve() call"
        ).observe(duration)
        m.gauge(
            "serve_tokens_per_second", "last serve() decode throughput"
        ).set(tokens / max(duration, 1e-9))
        if proposed:
            m.counter(
                "spec_drafts_proposed_total", "speculative drafts proposed"
            ).inc(proposed)
            m.counter(
                "spec_drafts_accepted_total", "speculative drafts accepted"
            ).inc(accepted)
            m.gauge(
                "spec_acceptance_rate", "last serve() draft acceptance rate"
            ).set(accepted / proposed)

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

    def _prefill(self, model, params, q: _Queue, req: int):
        """A full-prompt prefill forward of ``req`` (padding at position
        Pmax: invisible to real queries, dropped from the emitted cache),
        emitting the full-length cache of every layer and the logits of
        the last prompt row alone, (1, 1, V)."""
        Pmax, dev = self.ecfg.max_prompt_len, model.device
        plen = int(q.lens[req])
        idx = torch.arange(Pmax, dtype=torch.int32, device=dev)
        positions = torch.where(idx < plen, idx, Pmax)[None]
        return model.forward(params, q.prompts_d[req:req + 1],
                             positions=positions, mode="prefill",
                             cache_len=Pmax, full_cache=True,
                             readout=torch.tensor([plen - 1], device=dev))

    def _admit_full(self, params, q: _Queue, st: _Slots, pools, slot: int,
                    req: int, gtab_row: torch.Tensor, wtab_row=None,
                    draft=None):
        """One-shot admission: a full-prompt prefill forward, paged into the
        slot's pages (the ring of ``wtab_row`` for windowed layers), then
        the first token sampled (and the drafter's admission)."""
        plen = int(q.lens[req])
        logits, pcache = self._prefill(self.model, params, q, req)
        kv_cache.admit_slot(pools, pcache, self.model.cfg, self.spec,
                            gtab_row, plen, wtab_row=wtab_row)
        tok = q.draw(logits[:, 0],
                     torch.tensor([req], device=self.model.device), plen - 1)
        self._start(q, st, slot, req, int(tok[0]))
        if draft is not None:
            self._drafter_admit(draft, q, st, slot, req, int(tok[0]))

    def _drafter_admit(self, draft: _Draft, q: _Queue, st: _Slots, slot: int,
                       req: int, tok: int):
        """The drafter's admission: the same prompt prefilled into its own
        pools, and the catch-up context seeded with the last dk prompt
        tokens and the first sampled one (for plen <= dk the leading
        entries sit at positions < 0 in the catch-up chunk: masked and
        dropped)."""
        plen, dk = int(q.lens[req]), self.ecfg.draft_k
        _, dpcache = self._prefill(self.draft_model, draft.params, q, req)
        kv_cache.admit_slot(
            draft.pools, dpcache, self.draft_model.cfg, self.dspec,
            self.dgtable[slot], plen,
            wtab_row=None if self.dwtable is None else self.dwtable[slot])
        gidx = np.clip(plen - dk + np.arange(dk), 0, self.ecfg.max_prompt_len - 1)
        st.ctx[slot] = np.append(q.prompts[req, gidx], tok)

    def _decode(self, params, q: _Queue, st: _Slots, pools,
                gtable: torch.Tensor, wtable=None):
        """One (n_slots, 1) decode forward over all slots, sampling, and
        retirement on EOS or the length budget."""
        dev = self.model.device
        was_active = st.active.copy()
        positions = np.where(st.active, st.pos, -1)
        paged = kv_cache.PagedState(
            global_table=gtable, active=torch.as_tensor(st.active, device=dev),
            page_size=self.spec.page_size, window_table=wtable,
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

    def _decode_spec(self, params, q: _Queue, st: _Slots, pools,
                     gtable: torch.Tensor, wtable, draft: _Draft, k_eff=None):
        """One speculative iteration over all slots (draft -> verify ->
        accept -> commit), in place of :meth:`_decode`.  ``k_eff`` ((S,)
        in [1, draft_k], host data) cuts each slot's chain: draft j >=
        k_eff is force-rejected, its q row zeroed (the residual is then the
        plain target draw), its drafter and target writes dropped
        (positions -1), and ``proposed`` counts min(dk, k_eff).  The drafter
        still runs dk steps, as in the reference."""
        dev, dk = self.model.device, self.ecfg.draft_k
        S = self.spec.n_slots
        active, pos = st.active.copy(), st.pos
        joff = np.arange(dk + 1)
        k_used = np.full(S, dk) if k_eff is None else np.clip(k_eff, 1, dk)
        on_card = lambda a: torch.as_tensor(a, device=dev)
        at = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        act_d, req_d, pos_d = on_card(active), on_card(st.req), on_card(pos)

        # draft: the catch-up chunk at pos - dk .. pos, then dk single steps
        dpaged = kv_cache.PagedState(global_table=self.dgtable, active=act_d,
                                     page_size=self.dspec.page_size,
                                     window_table=self.dwtable)
        cpos = pos[:, None] - dk + joff
        cpos = np.where(active[:, None] & (cpos >= 0), cpos, -1)
        logits, _ = self.draft_model.forward(
            draft.params, on_card(st.ctx), positions=at(cpos), mode="decode",
            cache=draft.pools, paged=dpaged,
        )
        logits = logits[:, -1]
        drafts, dists = [], []
        for j in range(dk):
            dj, qj = q.propose(logits, req_d, pos_d + j)
            # feed the draft back (drafter entry at pos + 1 + j): the last
            # feed's logits go unused, its entry saves the next catch-up a
            # hole when every draft is accepted
            dpos = np.where(active & (j < k_used), pos + 1 + j, -1)[:, None]
            logits, _ = self.draft_model.forward(
                draft.params, dj[:, None], positions=at(dpos), mode="decode",
                cache=draft.pools, paged=dpaged,
            )
            logits = logits[:, 0]
            drafts.append(dj)
            dists.append(qj)
        drafts = torch.stack(drafts, dim=1)
        q_dist = None if q.all_greedy else torch.stack(dists, dim=1)
        jmask = None if k_eff is None else on_card(joff[:dk] < k_used[:, None])

        # verify: [last, d_0 .. d_{dk-1}] at pos .. pos + dk in one target
        # forward; row i is the target's logits for the token at pos + 1 + i
        vpos = np.where(active[:, None] & (joff <= k_used[:, None]),
                        pos[:, None] + joff, -1)
        paged = kv_cache.PagedState(global_table=gtable, active=act_d,
                                    page_size=self.spec.page_size,
                                    window_table=wtable)
        vlogits, _ = self.model.forward(
            params, torch.cat([on_card(st.last[:, None]), drafts], dim=1),
            positions=at(vpos), mode="decode", cache=pools, paged=paged,
        )
        n_acc, extra = q.accept(vlogits, drafts, q_dist, req_d, pos_d, jmask)
        # the iteration's one read-back: the drafts, the extra token, n_acc
        block = torch.cat([drafts, extra[:, None], n_acc[:, None]], dim=1)
        block = block.cpu().numpy().astype(np.int64)
        self._commit(st, active, block[:, :dk], block[:, dk], block[:, dk + 1],
                     k_used)

    def _commit(self, st: _Slots, active, drafts, extra, n_acc, k_used):
        """Commit the accepted drafts and the extra token of each active
        slot, cut at the first committed EOS and at the length budget;
        slide the catch-up context by the commit length."""
        S, dk = drafts.shape
        Gmax = self.ecfg.max_gen_len
        joff = np.arange(dk + 1)
        rows = np.arange(S)
        n_acc = np.where(active, n_acc, 0)
        cand = np.concatenate([drafts, np.zeros((S, 1), np.int64)], axis=1)
        cand[rows, n_acc] = extra
        in_commit = self._is_eos(cand) & (joff < n_acc[:, None] + 1)
        any_eos = in_commit.any(axis=1)
        first_eos = in_commit.argmax(axis=1)
        m = np.where(any_eos, first_eos + 1, n_acc + 1)
        m = np.where(active, np.minimum(m, Gmax - st.ntok), 0)
        for s in np.nonzero(active)[0]:
            n0 = st.ntok[s]
            st.out_toks[st.req[s], n0:n0 + m[s]] = cand[s, :m[s]]
        ntok = st.ntok + m
        st.out_len[st.req[active]] = ntok[active]
        finished = (any_eos & (first_eos < m)) | (ntok >= Gmax)
        upd = active & (m > 0)
        last_tok = cand[rows, np.maximum(m - 1, 0)]
        new_ctx = np.take_along_axis(np.concatenate([st.ctx, cand], axis=1),
                                     m[:, None] + joff, axis=1)
        st.active = active & ~finished
        st.pos = st.pos + m
        st.last = np.where(upd, last_tok, st.last)
        st.ntok = ntok
        st.ctx = np.where(upd[:, None], new_ctx, st.ctx)
        st.accepted += int(n_acc[active].sum())
        st.proposed += int(k_used[active].sum())
        st.last_acc = np.where(active, n_acc, 0)
        st.last_prop = np.where(active, k_used, 0)

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
        draft_params=None,        # drafter params (speculative engines only)
    ) -> Dict[str, object]:
        """Serve R requests; returns {"tokens": (R, max_gen_len) int32,
        "lengths": (R,) int32} as CPU tensors, "steps": the loop-iteration
        count, and "accepted" / "proposed": the speculative drafts (0 for a
        plain engine).  Generated tokens include the EOS, if hit."""
        if self.obs is None:
            return self._serve(params, prompts, prompt_lens, temperature,
                               top_k, top_p, seed, draft_params)
        tracer = self.obs.tracer
        t_start = time.monotonic()
        # every iteration ends in a read-back of its sampled tokens, so the
        # span closes after the serve's device work
        span = (tracer.span("serve", engine="static", requests=len(prompt_lens))
                if tracer is not None else contextlib.nullcontext())
        with span:
            out = self._serve(params, prompts, prompt_lens, temperature,
                              top_k, top_p, seed, draft_params)
        self._record_serve(
            duration=time.monotonic() - t_start, requests=len(prompt_lens),
            tokens=int(out["lengths"].sum()), steps=out["steps"],
            accepted=out["accepted"], proposed=out["proposed"],
        )
        return out

    def _serve(self, params, prompts, prompt_lens, temperature, top_k, top_p,
               seed, draft_params):
        S, Gmax = self.spec.n_slots, self.ecfg.max_gen_len
        draft = self._draft(draft_params, None)
        q = _Queue(prompts, prompt_lens, self.ecfg.max_prompt_len,
                   self.model.device, temperature, top_k, top_p, seed)
        R = q.R
        pools = kv_cache.init_pools(self.model.cfg, self.spec, self.model.device)
        if draft is not None:
            draft.pools = kv_cache.init_pools(self.draft_model.cfg, self.dspec,
                                              self.model.device)
        st = _Slots(S, R, Gmax, self.ecfg.draft_k)
        # <= R admissions + <= R*Gmax token steps; the counter is a backstop
        # against a scheduling bug, as in the reference
        max_steps = R * (Gmax + 1) + S + 2
        step = next_req = 0
        while (next_req < R or st.active.any()) and step < max_steps:
            if next_req < R and not st.active.all():
                slot = int(np.argmin(st.active))     # the first free slot
                wrow = None if self.wtable is None else self.wtable[slot]
                self._admit_full(params, q, st, pools, slot, next_req,
                                 self.gtable[slot], wrow, draft)
                next_req += 1
            if draft is None:
                self._decode(params, q, st, pools, self.gtable, self.wtable)
            else:
                self._decode_spec(params, q, st, pools, self.gtable,
                                  self.wtable, draft)
            step += 1
        return {
            "tokens": torch.from_numpy(st.out_toks),
            "lengths": torch.from_numpy(st.out_len),
            "steps": step,
            "accepted": st.accepted,
            "proposed": st.proposed,
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
    global-attention pages only: windowed configs (gemma2) run with sharing
    off, as in the reference, because decode overwrites ring pages in place
    and a shared ring page would be corrupted (serving/allocator.py).  Their
    ring pages come from a window pool of their own, popped at admission
    like the global pages.

    KV pools and the prefix cache persist across ``serve()`` calls, so a
    later serve hits prefixes cached by an earlier one; so do the drafter's
    pools, whose tables are static (the drafter shares no prefix pages).
    """

    def __init__(self, model, ecfg: EngineConfig = EngineConfig(),
                 draft_model=None, obs=None):
        C = ecfg.prefill_chunk
        if C < 0 or (C and C % ecfg.page_size):
            raise ValueError(
                f"prefill_chunk must be a multiple of page_size "
                f"({ecfg.page_size}), got {C}"
            )
        if ecfg.adaptive_draft and ecfg.draft_k < 1:
            raise ValueError(
                "adaptive_draft adapts the speculative draft length — it "
                f"needs draft_k >= 1 (got draft_k={ecfg.draft_k})"
            )
        # chunk forwards write up to chunk_len - 1 positions ahead of their
        # earliest query, speculative chunks up to draft_k: the windowed
        # ring needs that margin (kv_cache.build_spec)
        self._init_common(model, ecfg, draft_model,
                          lookahead=max(ecfg.draft_k, C - 1 if C else 0))
        self.obs = obs
        self._evicted_seen = 0      # prefix-cache eviction counter watermark
        spec = self.spec
        self.n_pages = ecfg.n_pages or spec.n_global_pages
        self.n_window_pages = ((ecfg.n_window_pages or spec.n_window_pages)
                               if spec.wp_cols else 0)
        self.blocks = BlockManager(
            n_pages=self.n_pages, page_size=spec.page_size,
            gp_cols=spec.gp_cols, wp_cols=spec.wp_cols,
            n_window_pages=self.n_window_pages,
            prefix_cache=ecfg.prefix_cache,
        )
        self._align = max(C // spec.page_size, 1)
        self._cmax = C if C else ecfg.max_prompt_len
        # host-side page tables, copied to the card when an admission
        # changes them
        self._gtab = np.zeros((spec.n_slots, spec.gp_cols), np.int32)
        self._wtab = (np.zeros((spec.n_slots, spec.wp_cols), np.int32)
                      if spec.wp_cols else None)
        self._tables_to_card()
        # pools persist across serve() calls: prefix-cached pages stay warm
        self._pools = kv_cache.init_pools(model.cfg, spec, model.device,
                                          n_global=self.n_pages,
                                          n_window=self.n_window_pages)
        self._dpools = (None if draft_model is None else
                        kv_cache.init_pools(draft_model.cfg, self.dspec,
                                            model.device))

    def _tables_to_card(self):
        dev = self.model.device
        self._gtab_d = torch.as_tensor(self._gtab, device=dev)
        self._wtab_d = (None if self._wtab is None
                        else torch.as_tensor(self._wtab, device=dev))

    def _record_dynamic(self, metrics, token_times, arr, prefill_total,
                        prefill_cached):
        """The dynamic engine's end-of-serve metrics: TTFT and inter-token
        latency from the per-token stamps, prompt tokens admitted and
        served from the prefix cache, and the allocator's page gauges."""
        blocks = self.blocks
        ttft_vals, itl_vals = [], []
        for r, ts in enumerate(token_times):
            if ts:
                ttft_vals.append(ts[0] - arr[r])
                itl_vals.extend(np.diff(ts))
        metrics.histogram(
            "serve_ttft_seconds", "arrival to first generated token"
        ).observe_many(ttft_vals)
        metrics.histogram(
            "serve_itl_seconds", "inter-token latency"
        ).observe_many(itl_vals)
        metrics.counter(
            "prefill_prompt_tokens_total", "prompt tokens admitted"
        ).inc(prefill_total)
        metrics.counter(
            "prefill_cached_tokens_total",
            "prompt tokens served from the prefix cache",
        ).inc(prefill_cached)
        if blocks.cache is not None:
            metrics.counter(
                "prefix_cache_evicted_pages_total",
                "pages LRU-evicted from the prefix cache",
            ).inc(blocks.cache.n_evicted - self._evicted_seen)
            self._evicted_seen = blocks.cache.n_evicted
            metrics.gauge(
                "prefix_cache_pages", "pages resident in the prefix cache",
            ).set(len(blocks.cache))
        metrics.gauge(
            "kv_pages_free", "free pages in the global pool"
        ).set(blocks.galloc.n_free)
        metrics.gauge(
            "kv_pages_allocated", "allocated pages (incl. cached)"
        ).set(blocks.galloc.n_allocated)

    # ------------------------------------------------------------------
    def _admit_chunk(self, params, q: _Queue, st: _Slots, cur, s0: int,
                     l0: int, last: bool, draft=None):
        """One prefill chunk of the current admission: a decode-mode forward
        of ``l0`` prompt tokens at positions s0.. (the rest of the fixed
        ``_cmax``-wide chunk at -1: masked everywhere, writes dropped; the
        fixed width, as in the reference, keeps a 1-token chunk on the
        multi-query path); on
        the last chunk, the first token sampled from the last chunk row,
        keyed exactly like the one-shot path — (plen - 1, req, SAMPLE) —
        and the drafter's admission."""
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
            window_table=(None if self._wtab_d is None
                          else self._wtab_d[slot:slot + 1]),
        )
        # only the chunk's last real row is ever sampled from
        logits, _ = self.model.forward(
            params, toks, positions=pos, mode="decode", cache=self._pools,
            paged=paged, readout=torch.tensor([max(l0 - 1, 0)], device=dev),
        )
        if last:
            plen = cur["plen"]
            tok = q.draw(logits[:, 0],
                         torch.tensor([req], device=dev), plen - 1)
            self._start(q, st, slot, req, int(tok[0]))
            if draft is not None:
                self._drafter_admit(draft, q, st, slot, req, int(tok[0]))

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
        draft_params=None,        # drafter params (speculative engines only)
        arrivals=None,            # (R,) seconds from serve start, ascending
        record_times: bool = False,
    ) -> Dict[str, Any]:
        """Serve R requests (FIFO, optionally arrival-gated).

        Returns the static engine's dict plus ``prefill_cached`` /
        ``prefill_total`` (prompt tokens served from shared pages vs total)
        and, with ``record_times``, ``token_times`` (per request, the
        ``time.monotonic()`` stamp relative to serve start of each emitted
        token) and the ``arrivals`` vector.  With ``obs`` attached the same
        stamps feed its TTFT and inter-token-latency histograms.
        """
        spec, blocks = self.spec, self.blocks
        S, Gmax, C = spec.n_slots, self.ecfg.max_gen_len, self.ecfg.prefill_chunk
        Pmax, dk0 = self.ecfg.max_prompt_len, self.ecfg.draft_k
        draft = self._draft(draft_params, self._dpools)
        q = _Queue(prompts, prompt_lens, Pmax, self.model.device,
                   temperature, top_k, top_p, seed)
        R = q.R
        arr = (np.zeros((R,), np.float64) if arrivals is None
               else np.asarray(arrivals, np.float64))
        st = _Slots(S, R, Gmax, dk0)
        # adaptive draft length: a per-slot EMA of the acceptance rate steers
        # the next iteration's chain length (pure host control)
        adaptive = self.ecfg.adaptive_draft
        k_cur = np.full(S, dk0, np.int64)
        acc_ema = np.full(S, 0.5, np.float64)
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
        obs = self.obs
        metrics = obs.metrics if obs is not None else None
        tracer = obs.tracer if obs is not None else None
        step_hist = (
            metrics.histogram(
                "serve_step_seconds", "wall time per dynamic-engine step"
            ) if metrics is not None else None
        )
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
                    if self._wtab is not None:
                        self._wtab[slot, :] = adm.wtab_row
                    self._tables_to_card()
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
                    if tracer is not None:
                        tracer.event(
                            "admission", req=req, slot=slot, plen=plen,
                            cached=c, chunks=len(chunks) if chunks else 0,
                        )
            # ---- this step's admission work ----
            finishing = None
            phase = "verify" if draft is not None else "decode"
            if cur is not None:
                phase = "prefill" if cur["chunks"] is None else "chunk_prefill"
                if cur["chunks"] is None:
                    slot = cur["slot"]
                    self._admit_full(
                        params, q, st, self._pools, slot, cur["req"],
                        self._gtab_d[slot],
                        None if self._wtab_d is None else self._wtab_d[slot],
                        draft)
                    finishing, cur = cur, None
                else:
                    s0, l0 = cur["chunks"][cur["i"]]
                    if cur["i"] == 0:
                        # freshly popped pages may hold a previous
                        # occupant's entries; shared pages are never reset
                        adm = cur["adm"]
                        kv_cache.invalidate_pages(
                            self._pools, self.model.cfg, adm.fresh_pages,
                            adm.fresh_wpages if self._wtab is not None else None)
                    last = cur["i"] == len(cur["chunks"]) - 1
                    self._admit_chunk(params, q, st, cur, s0, l0, last, draft)
                    if last:
                        finishing, cur = cur, None
                    else:
                        cur["i"] += 1
            # ---- one decode step over all slots, if any is active ----
            if st.active.any() and draft is None:
                self._decode(params, q, st, self._pools, self._gtab_d,
                             self._wtab_d)
            elif st.active.any():
                self._decode_spec(params, q, st, self._pools, self._gtab_d,
                                  self._wtab_d, draft,
                                  k_eff=k_cur if adaptive else None)
            steps += 1
            tnow = time.monotonic() - t0
            if tracer is not None:
                tracer.complete("step", t0 + now, t0 + tnow, phase=phase)
            if step_hist is not None:
                step_hist.observe(tnow - now)
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
            if adaptive:
                # confident drafters earn longer chains, struggling ones
                # shorter.  As in the reference, a step that ran no decode
                # reads the last speculative iteration's counts again.
                stepped = st.last_prop > 0
                rate = st.last_acc[stepped] / st.last_prop[stepped]
                acc_ema[stepped] = 0.8 * acc_ema[stepped] + 0.2 * rate
                grow = stepped & (acc_ema > 0.8)
                shrink = stepped & (acc_ema < 0.4)
                k_cur[grow] = np.minimum(k_cur[grow] + 1, dk0)
                k_cur[shrink] = np.maximum(k_cur[shrink] - 1, 1)
            for slot in sorted(occupied):
                if not st.active[slot]:
                    if tracer is not None:
                        tracer.event("retire", slot=slot, req=occupied[slot])
                    blocks.retire(slot)
                    del occupied[slot]
                    free.append(slot)
                    if adaptive:     # the next occupant starts afresh
                        k_cur[slot] = dk0
                        acc_ema[slot] = 0.5
            if steps > max_steps:
                raise RuntimeError(
                    f"dynamic engine exceeded {max_steps} steps — "
                    "host scheduler bug"
                )

        out = {
            "tokens": torch.from_numpy(st.out_toks),
            "lengths": torch.from_numpy(st.out_len),
            "steps": steps,
            "accepted": st.accepted,
            "proposed": st.proposed,
            "prefill_cached": prefill_cached,
            "prefill_total": prefill_total,
        }
        if obs is not None:
            self._record_serve(
                duration=time.monotonic() - t0, requests=R,
                tokens=int(sum(len(ts) for ts in token_times)),
                steps=steps, accepted=st.accepted, proposed=st.proposed,
            )
            self._record_dynamic(metrics, token_times, arr, prefill_total,
                                 prefill_cached)
        if record_times:
            out["token_times"] = token_times
            out["arrivals"] = arr
        return out
