"""The port's speculative decoding against the reference: the sampler's
explicit distributions and rejection step, and both engines with a drafter.

On the smoke smollm config with the reference's weights moved over by
``convert.params_from_numpy`` (the reference initialised with
``jax_threefry_partitionable=False``, the default its seed-picked tests were
written under).  The drafter is the target's narrow µP proxy with random
weights (acceptance near chance: the rejection and residual path) or the
target itself (acceptance 1: the bonus path).  Greedy serving must match the
reference's speculative engines token for token, with the same lengths,
steps and accepted / proposed counts.  Sampled serving cannot match draw for
draw (torch cannot replay ``jax.random``), so it is held by distribution to
the port's own non-speculative engine.  The copy task (data/copy_task.py)
trains a target and its depth-1 proxy until acceptance is near one.  On a
card only, both engines' speculative serves through the kernels against the
plain versions.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.transfer import make_proxy  # noqa: E402
from repro_torch.data.copy_task import copy_batch, train_copy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    DynamicEngine,
    Engine,
    EngineConfig,
)

_ECFG = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The reference, imported only by the tests that compare with it (the
    machine with the card runs the GPU tests without JAX), initialising
    under ``jax_threefry_partitionable=False`` while the module runs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.model import build_model
    from repro.serving import sampling as jsampling
    from repro.serving import engine as jengine

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield types.SimpleNamespace(
        jax=jax, jnp=jnp, smoke=get_smoke_config, build=build_model,
        sampling=jsampling, Engine=jengine.Engine,
        DynamicEngine=jengine.DynamicEngine, EngineConfig=jengine.EngineConfig,
    )
    jax.config.update("jax_threefry_partitionable", old)


def _pair(jx, jcfg, tcfg, seed):
    """The reference's model initialised from PRNGKey(seed) and the port's
    on the same weights."""
    jm = jx.build(jcfg)
    jp = jm.init(jx.jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _models(jx, **over):
    """Target (PRNGKey(0)) and its proxy drafter cfg.scaled(0.5,
    min_d_head=8) (PRNGKey(7)), reference and port, as the reference's
    tests/test_speculative.py builds them."""
    jcfg = jx.smoke("smollm-135m").replace(dtype="float32", **over)
    tcfg = t_smoke("smollm-135m").replace(dtype="float32", **over)
    target = _pair(jx, jcfg, tcfg, 0)
    drafter = _pair(jx, jcfg.scaled(0.5, min_d_head=8),
                    tcfg.scaled(0.5, min_d_head=8), 7)
    return target, drafter


@pytest.fixture(scope="module")
def models(jx):
    """A random query projection, so attention is not uniform."""
    return _models(jx, zero_init_query=False)


@pytest.fixture(scope="module")
def ref_models(jx):
    """The reference's own test configuration."""
    return _models(jx)


def _prompts(V, R, L, seed=1):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, V, (R, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, R).astype(np.int32)
    return prompts, lens


def _same_spec_serve(got, want):
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert (got["steps"], got["accepted"], got["proposed"]) == (
        int(want["steps"]), int(want["accepted"]), int(want["proposed"]))
    if "prefill_cached" in want:
        assert (got["prefill_cached"], got["prefill_total"]) == \
            (want["prefill_cached"], want["prefill_total"])


# ---------------------------------------------------------------------------
# sampling: filtered_dist and spec_accept
# ---------------------------------------------------------------------------

def test_filtered_dist_matches_reference(jx):
    """Greedy, temperature, top-k, top-p and combined rows: the same
    probabilities as the reference's filtered_dist (atol 1e-6)."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    temp = np.array([0.0, 1.0, 0.7, 1.3, 0.9, 0.5], np.float32)
    top_k = np.array([0, 0, 5, 0, 8, 1], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.8, 0.6, 1.0], np.float32)
    jnp = jx.jnp
    want = np.asarray(jx.sampling.filtered_dist(jnp.asarray(logits), jnp.asarray(temp),
                                                jnp.asarray(top_k), jnp.asarray(top_p)))
    got = sampling.filtered_dist(torch.from_numpy(logits), torch.from_numpy(temp),
                                 torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the greedy row is the one-hot argmax; every row sums to one
    assert got[0].argmax() == int(np.argmax(logits[0])) and got[0].max() == 1.0
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_spec_accept_greedy_exact(jx, seed):
    """One-hot p and q (the reference's test_spec_accept_greedy_exact): a
    draft is accepted iff it is the target's argmax, and the extra token is
    the target's argmax; n_acc and extra equal the reference's."""
    V = 16
    jax, jnp, jsampling = jx.jax, jx.jnp, jx.sampling
    rng = np.random.default_rng(seed)
    p_log, q_log = rng.standard_normal((2, 1, V)).astype(np.float32)
    greedy = (np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32))
    jp, jq = (jsampling.filtered_dist(jnp.asarray(x), *map(jnp.asarray, greedy))[0]
              for x in (p_log, q_log))
    tp, tq = (sampling.filtered_dist(torch.from_numpy(x), *map(torch.from_numpy, greedy))[0]
              for x in (p_log, q_log))
    jkeys = jax.random.split(jax.random.PRNGKey(4 + seed), 2)
    akeys = sampling.event_key(seed, torch.tensor([[0]]), 0, 1, "cpu")
    skeys = sampling.event_key(seed, torch.tensor([[0, 1]]), 0, 0, "cpu")
    best = int(np.argmax(p_log))
    for d in (best, int(np.argmax(q_log)), 0):
        n_j, x_j = jsampling.spec_accept(
            jnp.stack([jp, jp])[None], jq[None, None], jnp.array([[d]], jnp.int32),
            jkeys[0].reshape(1, 1, 2), jnp.stack([jkeys[1]] * 2)[None])
        n_t, x_t = sampling.spec_accept(torch.stack([tp, tp])[None], tq[None, None],
                                        torch.tensor([[d]]), akeys, skeys)
        assert (int(n_t[0]), int(x_t[0])) == (int(n_j[0]), int(x_j[0]))
        assert int(n_t[0]) == (d == best) and int(x_t[0]) == best


@pytest.mark.parametrize("truncated", [False, True], ids=["chain", "accept_mask"])
def test_spec_accept_marginal_is_the_target(truncated):
    """Draft ~ q, accept with p/q, resample from the residual, over 6,000
    chains of hashed keys at V = 8: the first committed token's marginal is
    p within the reference's TV bound (0.03).  With ``accept_mask`` cutting
    a 2-draft chain after the first (its q row zeroed, as the adaptive
    engine does), the token committed after an accepted first draft follows
    the second position's p."""
    V, N = 8, 6000
    rng = np.random.default_rng(0)
    logit = lambda: torch.from_numpy((rng.standard_normal((1, V)) * 1.5).astype(np.float32))
    one = lambda t, k, p: (torch.tensor([t]), torch.tensor([k], dtype=torch.int32),
                           torch.tensor([p]))
    p0 = sampling.filtered_dist(logit(), *one(0.9, 5, 0.85))[0]
    q0 = sampling.filtered_dist(logit(), *one(1.1, 0, 1.0))[0]
    p1 = sampling.filtered_dist(logit(), *one(1.0, 0, 1.0))[0]
    q1 = sampling.filtered_dist(logit(), *one(0.8, 0, 1.0))[0]
    chain = torch.arange(N)
    k = 2 if truncated else 1
    grid = chain[:, None] * 4 + torch.arange(k + 1)
    drafts = torch.stack([sampling.categorical_from(
        sampling.event_key(1, grid[:, j], chain, 2, "cpu"), q.expand(N, V))
        for j, q in enumerate((q0, q1)[:k])], dim=1)
    p_dist = torch.stack([p0, p1, p1][:k + 1])[None].expand(N, k + 1, V)
    q_dist = torch.stack([q0, q1][:k])[None].expand(N, k, V).clone()
    mask = None
    if truncated:
        mask = torch.tensor([[True, False]]).expand(N, 2)
        q_dist[:, 1] = 0.0
    n_acc, extra = sampling.spec_accept(
        p_dist, q_dist, drafts, sampling.event_key(1, grid[:, :k], chain[:, None], 1, "cpu"),
        sampling.event_key(1, grid, chain[:, None], 0, "cpu"), accept_mask=mask)
    assert int(n_acc.max()) <= 1
    first = torch.where(n_acc > 0, drafts[:, 0], extra)
    tv = lambda toks, p: 0.5 * np.abs(np.bincount(toks.numpy(), minlength=V) / len(toks)
                                      - p.numpy()).sum()
    assert tv(first, p0) < 0.03
    if truncated:
        second = extra[n_acc == 1]
        assert len(second) > N // 4
        assert tv(second, p1) < 0.03


# ---------------------------------------------------------------------------
# engines against the reference's speculative engines (greedy)
# ---------------------------------------------------------------------------

def test_static_spec_matches_reference(jx, models):
    """The static engine with the proxy drafter at k = 2 and self-drafting
    at k = 3: tokens, lengths, steps, accepted and proposed equal the
    reference's; greedy tokens equal the non-speculative engine's."""
    (jm, jp, tm, tp), (jdm, jdp, tdm, tdp) = models
    prompts, lens = _prompts(jm.cfg.vocab_size, R=5, L=16)
    base = Engine(tm, EngineConfig(**_ECFG)).serve(tp, prompts, lens)
    for (jd, jdpar, td, tdpar), k in (((jdm, jdp, tdm, tdp), 2), ((jm, jp, tm, tp), 3)):
        got = Engine(tm, EngineConfig(**_ECFG, draft_k=k), draft_model=td).serve(
            tp, prompts, lens, draft_params=tdpar)
        want = jx.Engine(jm, jx.EngineConfig(**_ECFG, draft_k=k), draft_model=jd).serve(
            jp, prompts, lens, draft_params=jdpar)
        _same_spec_serve(got, want)
        assert torch.equal(got["tokens"], base["tokens"])
        assert got["proposed"] > 0 and got["steps"] <= base["steps"]


@pytest.mark.parametrize("knobs", [
    dict(prefill_chunk=8, prefix_cache=True),
    dict(prefill_chunk=4, prefix_cache=True, adaptive_draft=True),
    dict(prefix_cache=True, adaptive_draft=True),
], ids=["chunk8_prefix_cache", "chunk4_prefix_cache_adaptive", "prefix_cache_adaptive"])
def test_dynamic_spec_matches_reference(jx, models, knobs):
    """DynamicEngine with the proxy drafter at k = 3, prefix cache and
    chunked prefill, with and without the adaptive draft length: equal to
    the reference's on a cold and a warm cache (the drafter's pools persist
    across serves)."""
    (jm, jp, tm, tp), (jdm, jdp, tdm, tdp) = models
    prompts, lens = _prompts(jm.cfg.vocab_size, R=5, L=16, seed=3)
    prompts[1:3, :8] = prompts[0, :8]            # shared prefixes
    lens[:3] = [16, 13, 10]
    ecfg = dict(_ECFG, draft_k=3, **knobs)
    ours = DynamicEngine(tm, EngineConfig(**ecfg), draft_model=tdm)
    theirs = jx.DynamicEngine(jm, jx.EngineConfig(**ecfg), draft_model=jdm)
    for _ in range(2):
        _same_spec_serve(ours.serve(tp, prompts, lens, draft_params=tdp),
                         theirs.serve(jp, prompts, lens, draft_params=jdp))
        ours.blocks.check_invariants()
    assert ours.blocks.cache.n_hit_pages > 0


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_int8_pools_spec_matches_reference(jx, static):
    """int8 paged pools for target and drafter (the drafter's config
    inherits kv_dtype through cfg.scaled)."""
    (jm, jp, tm, tp), (jdm, jdp, tdm, tdp) = _models(jx, zero_init_query=False,
                                                       kv_dtype="int8")
    assert tdm.cfg.kv_dtype == "int8"
    prompts, lens = _prompts(jm.cfg.vocab_size, R=4, L=16, seed=5)
    knobs = {} if static else dict(prefill_chunk=8, adaptive_draft=True)
    cls, jcls = (Engine, jx.Engine) if static else (DynamicEngine, jx.DynamicEngine)
    got = cls(tm, EngineConfig(**_ECFG, draft_k=3, **knobs), draft_model=tdm).serve(
        tp, prompts, lens, draft_params=tdp)
    want = jcls(jm, jx.EngineConfig(**_ECFG, draft_k=3, **knobs), draft_model=jdm).serve(
        jp, prompts, lens, draft_params=jdp)
    _same_spec_serve(got, want)


def test_spec_eos_mid_chunk_retirement(jx, ref_models):
    """The reference's EOS scenario (test_spec_eos_mid_draft_retirement,
    under the threefry flag it was written with): an EOS inside an accepted
    chunk cuts the commit there.  Lengths and tokens equal the
    non-speculative engine's and the reference's speculative engine's, and
    some row stops strictly inside the budget."""
    (jm, jp, tm, tp), _ = ref_models
    rand = jx.jax.random
    prompts = np.asarray(rand.randint(rand.PRNGKey(2), (5, 16), 0, jm.cfg.vocab_size))
    lens = np.asarray(rand.randint(rand.PRNGKey(3), (5,), 1, 17))
    toks = Engine(tm, EngineConfig(**_ECFG)).serve(tp, prompts, lens)["tokens"].numpy()
    Gmax = _ECFG["max_gen_len"]
    eos = -1
    for e in np.unique(toks):
        first = np.where((toks == e).any(1), (toks == e).argmax(1) + 1, Gmax)
        if np.any((first > 1) & (first < Gmax)):
            eos = int(e)
            break
    assert eos >= 0, toks
    want = Engine(tm, EngineConfig(**_ECFG, eos_token_id=eos)).serve(tp, prompts, lens)
    ecfg = dict(_ECFG, eos_token_id=eos, draft_k=3)
    got = Engine(tm, EngineConfig(**ecfg), draft_model=tm).serve(
        tp, prompts, lens, draft_params=tp)
    ref = jx.Engine(jm, jx.EngineConfig(**ecfg), draft_model=jm).serve(
        jp, prompts, lens, draft_params=jp)
    _same_spec_serve(got, ref)
    L = want["lengths"].numpy()
    np.testing.assert_array_equal(got["lengths"].numpy(), L)
    for r in range(len(L)):
        np.testing.assert_array_equal(got["tokens"][r, :L[r]], want["tokens"][r, :L[r]])
    assert np.any((L > 1) & (L < Gmax)), L


# ---------------------------------------------------------------------------
# sampled speculative serving
# ---------------------------------------------------------------------------

def test_sampled_spec_matches_target_distribution(models):
    """Temperature 0.7, top-k 4: the (first, second) generated-token pairs
    of 192 i.i.d. requests (one prompt, per-request keys) under the proxy
    drafter against the port's non-speculative engine, TV < 0.25 (the
    reference's bound).  The smoke models at init repeat the last token
    almost surely, which would leave one pair per first token; a flatter
    readout (output multiplier alpha_output 0.1, the same weights) spreads
    both positions over their top 4, and the drafter's acceptance stays
    well below 1, so most tokens go through the residual path.  A bias
    there (say, drawing from the drafter) would push TV toward 1."""
    (_, _, tm, tp), (_, _, tdm, tdp) = models
    flat = lambda m: tbuild(m.cfg.replace(alpha_output=0.1), device="cpu")
    tm, tdm = flat(tm), flat(tdm)
    R, L = 192, 8
    rng = np.random.default_rng(17)
    prompts = np.tile(rng.integers(0, tm.cfg.vocab_size, (1, L)), (R, 1))
    lens = np.full(R, L)
    kw = dict(temperature=torch.full((R,), 0.7), top_k=torch.full((R,), 4, dtype=torch.int32),
              seed=13)
    ecfg = dict(n_slots=8, page_size=4, max_prompt_len=8, max_gen_len=2)
    a = Engine(tm, EngineConfig(**ecfg)).serve(tp, prompts, lens, **kw)
    b = Engine(tm, EngineConfig(**ecfg, draft_k=2), draft_model=tdm).serve(
        tp, prompts, lens, draft_params=tdp, **kw)
    assert 0 < b["accepted"] < b["proposed"] // 2
    pairs = lambda out: [tuple(row) for row in out["tokens"].numpy().tolist()]
    support = sorted(set(pairs(a)) | set(pairs(b)))
    pa = np.array([pairs(a).count(s) for s in support], float) / R
    pb = np.array([pairs(b).count(s) for s in support], float) / R
    tv = 0.5 * np.abs(pa - pb).sum()
    assert len(support) > 8 and tv < 0.25, (tv, support)


def test_sampled_spec_deterministic_and_invariant_to_arrivals(models):
    """A sampled speculative serve is a pure function of (seed, request,
    position): the same seed gives the same tokens twice, staggered
    arrivals on the dynamic engine give the same tokens, and (the
    reference's test_stochastic_stream_invariant_to_admission_timing) a
    request's stream does not move when the request before it in a
    one-slot engine changes."""
    (_, _, tm, tp), (_, _, tdm, tdp) = models
    prompts, lens = _prompts(tm.cfg.vocab_size, R=4, L=16, seed=3)
    kw = dict(temperature=torch.tensor([0.0, 1.0, 0.7, 0.9]),
              top_k=torch.tensor([0, 0, 8, 4], dtype=torch.int32), seed=5,
              draft_params=tdp)
    eng = DynamicEngine(tm, EngineConfig(**_ECFG, draft_k=2, prefill_chunk=8,
                                         adaptive_draft=True), draft_model=tdm)
    a = eng.serve(tp, prompts, lens, **kw)
    b = eng.serve(tp, prompts, lens, **kw)
    c = eng.serve(tp, prompts, lens, arrivals=[0.0, 0.02, 0.05, 0.06], **kw)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["tokens"], c["tokens"])
    # the same events in both engines at a fixed draft length
    d = DynamicEngine(tm, EngineConfig(**_ECFG, draft_k=2), draft_model=tdm).serve(
        tp, prompts, lens, **kw)
    e = Engine(tm, EngineConfig(**_ECFG, draft_k=2), draft_model=tdm).serve(
        tp, prompts, lens, **kw)
    assert torch.equal(d["tokens"], e["tokens"])

    one = Engine(tm, EngineConfig(n_slots=1, page_size=4, max_prompt_len=16,
                                  max_gen_len=6, draft_k=2), draft_model=tm)
    rng = np.random.default_rng(21)
    pa = rng.integers(0, tm.cfg.vocab_size, (1, 16))
    streams = []
    for seed_b in (31, 32):
        pb = np.random.default_rng(seed_b).integers(0, tm.cfg.vocab_size, (1, 16))
        out = one.serve(tp, np.concatenate([pb, pa]), np.array([16, 9]),
                        temperature=torch.tensor([0.9, 1.0]),
                        top_k=torch.tensor([0, 8], dtype=torch.int32), seed=2,
                        draft_params=tp)
        streams.append(out["tokens"][1])
    assert torch.equal(streams[0], streams[1])


# ---------------------------------------------------------------------------
# writes past the budget
# ---------------------------------------------------------------------------

def test_verify_writes_past_the_budget_stay_in_the_slot(models):
    """Request 0 (a full-length prompt) has verify chunks that run past
    max_prompt_len + max_gen_len; request 1 decodes beside it.  Request 1's
    pages (target and drafter) are byte-equal to those of a serve whose
    request 0 never runs past the budget, and the pool's spare pages are
    never written."""
    (_, _, tm, tp), (_, _, tdm, tdp) = models
    prompts, _ = _prompts(tm.cfg.vocab_size, R=2, L=16, seed=9)
    ecfg = dict(_ECFG, max_gen_len=8)
    max_total = ecfg["max_prompt_len"] + ecfg["max_gen_len"]
    seen = []

    class Recording(type(tm)):
        def forward(self, params, tokens, positions=None, mode="train", **kw):
            if mode == "decode":
                seen.append(int(positions.max()))
            return super().forward(params, tokens, positions=positions, mode=mode, **kw)

    rec = Recording(tm.cfg, device="cpu")

    def serve(len0):
        eng = DynamicEngine(rec, EngineConfig(**ecfg, draft_k=3, n_pages=2 * 6 + 2),
                            draft_model=tdm)
        seen.clear()
        eng.serve(tp, prompts, np.array([len0, 11]), draft_params=tdp)
        pools = [eng._pools["groups"][k]["attn"] for k in sorted(eng._pools["groups"])]
        dpools = [eng._dpools["groups"][k]["attn"] for k in sorted(eng._dpools["groups"])]
        return eng, max(seen), pools, dpools

    eng, far, pools, dpools = serve(16)
    _, near, pools_b, dpools_b = serve(2)
    assert far > max_total - 1 >= near
    gp = eng.spec.gp_cols
    assert gp * ecfg["page_size"] == max_total        # past the budget means past the pages
    # the allocator's LIFO free list gives both serves the same pages
    mine = torch.as_tensor(eng._gtab[1]).long()
    spare = torch.as_tensor(sorted(set(range(eng.n_pages)) - set(eng._gtab[:2].ravel())))
    assert len(spare) == 2
    for a, b in zip(pools, pools_b):
        for leaf in ("k", "v", "pos"):
            assert torch.equal(a[leaf][:, mine], b[leaf][:, mine]), leaf
        assert bool((a["pos"][:, spare] == -1).all())
    drows = eng.dgtable[1].long()
    for a, b in zip(dpools, dpools_b):
        for leaf in ("k", "v", "pos"):
            assert torch.equal(a[leaf][:, drows], b[leaf][:, drows]), leaf


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_spec_validation(models):
    (_, _, tm, tp), (_, _, tdm, tdp) = models
    with pytest.raises(ValueError, match="draft_k >= 1 and a draft_model"):
        Engine(tm, EngineConfig(**_ECFG, draft_k=2))
    with pytest.raises(ValueError, match="draft_k >= 1 and a draft_model"):
        DynamicEngine(tm, EngineConfig(**_ECFG), draft_model=tdm)
    with pytest.raises(ValueError, match="need the dynamic engine"):
        Engine(tm, EngineConfig(**_ECFG, draft_k=2, adaptive_draft=True), draft_model=tdm)
    with pytest.raises(ValueError, match="needs draft_k >= 1"):
        DynamicEngine(tm, EngineConfig(**_ECFG, adaptive_draft=True))
    other = tbuild(tdm.cfg.replace(vocab_size=256), device="cpu")
    with pytest.raises(ValueError, match="drafter vocab must match"):
        Engine(tm, EngineConfig(**_ECFG, draft_k=2), draft_model=other)
    prompts, lens = _prompts(tm.cfg.vocab_size, R=2, L=16)
    for cls in (Engine, DynamicEngine):
        eng = cls(tm, EngineConfig(**_ECFG, draft_k=2), draft_model=tdm)
        with pytest.raises(ValueError, match="needs draft_params"):
            eng.serve(tp, prompts, lens)
    # a plain engine reports no speculation
    out = Engine(tm, EngineConfig(**_ECFG)).serve(tp, prompts, lens)
    assert (out["accepted"], out["proposed"]) == (0, 0)


# ---------------------------------------------------------------------------
# the copy task: acceptance near one
# ---------------------------------------------------------------------------

def test_copy_task_drafter_is_accepted():
    """A smoke target trained 100 steps on the copy task and its width-0.5,
    depth-1 proxy trained 150 (the reference's perf_serve recipe): the
    speculative serve at draft_k 6 gives the non-speculative engine's greedy
    tokens with nearly every draft accepted and a fraction of its
    iterations."""
    cfg = t_smoke("smollm-135m").replace(dtype="float32")
    model, params, loss = train_copy(cfg, steps=100, seed=0, device="cpu")
    dmodel, dparams, dloss = train_copy(make_proxy(cfg, 0.5, depth=1, min_d_head=8),
                                        steps=150, seed=1, device="cpu")
    assert (len(loss), len(dloss)) == (100, 150) and dmodel.cfg.n_layers == 1
    assert max(loss[-1], dloss[-1]) < 0.05
    prompts = copy_batch(np.random.RandomState(2), cfg.vocab_size, 8, 8)
    lens = np.full(8, 8)
    ecfg = dict(n_slots=4, page_size=16, max_prompt_len=8, max_gen_len=48)
    base = Engine(model, EngineConfig(**ecfg)).serve(params, prompts, lens)
    spec = Engine(model, EngineConfig(**ecfg, draft_k=6), draft_model=dmodel).serve(
        params, prompts, lens, draft_params=dparams)
    assert torch.equal(spec["tokens"], base["tokens"])
    assert spec["accepted"] >= 0.9 * spec["proposed"] > 0
    assert spec["steps"] * 3 < base["steps"]


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_spec_engines_on_card_match_plain(kv_dtype):
    """At smoke size on the card, both engines' speculative serves (the
    dynamic one with the prefix cache, chunks and the adaptive draft length)
    through the kernels give the plain versions' tokens, lengths, steps and
    accepted / proposed counts, and launch B8 (drafter steps) and B9
    (catch-up, verify, chunks) in the pools' mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    cfg = t_smoke("smollm-135m").replace(dtype="float32", zero_init_query=False,
                                         kv_dtype=kv_dtype)
    dcfg = cfg.scaled(0.5, min_d_head=8)
    kern, dkern = tbuild(cfg, device="cuda"), tbuild(dcfg, device="cuda")
    plain = tbuild(cfg, device="cuda", impl="ref")
    dplain = tbuild(dcfg, device="cuda", impl="ref")
    params, dparams = kern.init(0), dkern.init(7)
    prompts, lens = _prompts(cfg.vocab_size, R=5, L=16, seed=3)
    sfx = "_int8" if kv_dtype else ""
    for cls, knobs in ((Engine, {}), (DynamicEngine, dict(
            prefill_chunk=8, prefix_cache=True, adaptive_draft=True))):
        ecfg = EngineConfig(**_ECFG, draft_k=3, **knobs)
        ops.reset_launch_counts()
        got = cls(kern, ecfg, draft_model=dkern).serve(params, prompts, lens,
                                                       draft_params=dparams)
        counts = ops.launch_counts()
        want = cls(plain, ecfg, draft_model=dplain).serve(params, prompts, lens,
                                                          draft_params=dparams)
        for key in ("tokens", "lengths"):
            assert torch.equal(got[key], want[key]), key
        for key in ("steps", "accepted", "proposed"):
            assert got[key] == want[key], key
        assert counts["flash_decode" + sfx] > 0 and counts["flash_decode_multi" + sfx] > 0
