"""The port's dynamic serving engine (page allocator, radix-tree prefix
cache, chunked prefill) against the reference's ``DynamicEngine`` and
against the port's static engine, and the multi-token paged decode forward
that its chunks run.

On the smoke smollm config with the reference's weights moved over by
``convert.params_from_numpy``.  Greedy serving must match the reference
token for token, with the same lengths, step count and prefix-cache
accounting.  Sampled serving cannot match the reference draw for draw
(torch cannot replay ``jax.random``), so it is held to the port's static
engine, whose keys are the same (seed, request, position) events.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import DynamicEngine as JDynamicEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.allocator import PoolExhausted  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    DynamicEngine,
    Engine,
    EngineConfig,
)

# the reference's dynamic-engine geometry and overlap workload
# (tests/test_serving.py), copied
_DYN = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=6)


def _overlap_prompts(cfg, L=16, seed=21):
    """5 prompts exercising every overlap class: rows 0-2 share a 2-page
    (8-token) prefix with distinct tails and non-page-multiple lengths,
    row 3 shares exactly 1 full page + half of the next, row 4 is disjoint."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    base = rng.integers(0, V, size=L)
    rows = []
    for _ in range(3):
        r = base.copy()
        r[8:] = rng.integers(0, V, size=L - 8)
        rows.append(r)
    partial = base.copy()
    partial[6:] = rng.integers(0, V, size=L - 6)
    rows.append(partial)
    rows.append(rng.integers(0, V, size=L))
    prompts = np.stack(rows).astype(np.int32)
    lens = np.asarray([16, 12, 9, 16, 16], np.int32)
    return prompts, lens


def _prompts(cfg, R, L, seed=1):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (R, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, R).astype(np.int32)
    return prompts, lens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Reference and port smollm smoke models on the same weights (a random
    query projection, so attention is not uniform)."""
    over = dict(dtype="float32", zero_init_query=False)
    jcfg, tcfg = j_smoke("smollm-135m", **over), t_smoke("smollm-135m", **over)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _same_serve(got, want):
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert got["steps"] == int(want["steps"])
    assert (got["prefill_cached"], got["prefill_total"]) == \
        (want["prefill_cached"], want["prefill_total"])


# ---------------------------------------------------------------------------
# against the reference's DynamicEngine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(),                                     # one shot, allocator only
    dict(prefill_chunk=4),
    dict(prefill_chunk=8),
    dict(prefix_cache=True),                    # one suffix chunk per hit
    dict(prefill_chunk=4, prefix_cache=True),
], ids=["one_shot", "chunk4", "chunk8", "prefix_cache", "chunk4_prefix_cache"])
def test_dynamic_matches_reference_dynamic_engine(models, knobs):
    """Greedy tokens, lengths, steps and prefill_cached/prefill_total equal
    the reference's, on a cold and then a warm cache."""
    jm, jp, tm, tp = models
    prompts, lens = _overlap_prompts(jm.cfg)
    ours = DynamicEngine(tm, EngineConfig(**_DYN, **knobs))
    theirs = JDynamicEngine(jm, JEngineConfig(**_DYN, **knobs))
    for _ in range(2):
        _same_serve(ours.serve(tp, prompts, lens), theirs.serve(jp, prompts, lens))
        ours.blocks.check_invariants()
    if knobs.get("prefix_cache"):
        assert ours.blocks.cache.n_hit_pages > 0


def test_dynamic_with_eos_matches_reference(models):
    """Requests that stop at an EOS retire early and free their pages for
    the queue, as in the reference."""
    jm, jp, tm, tp = models
    prompts, lens = _prompts(jm.cfg, R=5, L=16, seed=3)
    kw = dict(_DYN, prefill_chunk=8, prefix_cache=True)
    plain = DynamicEngine(tm, EngineConfig(**kw)).serve(tp, prompts, lens)
    eos = int(plain["tokens"][0, 2])            # request 0 stops by its 3rd token
    got = DynamicEngine(tm, EngineConfig(eos_token_id=eos, **kw)).serve(
        tp, prompts, lens)
    want = JDynamicEngine(jm, JEngineConfig(eos_token_id=eos, **kw)).serve(
        jp, prompts, lens)
    _same_serve(got, want)
    assert got["lengths"][0] <= 3


# ---------------------------------------------------------------------------
# against the port's static engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(), dict(prefill_chunk=4), dict(prefill_chunk=12),
    dict(prefill_chunk=8, prefix_cache=True),
], ids=["one_shot", "chunk4", "chunk12", "chunk8_prefix_cache"])
def test_dynamic_matches_static_greedy_and_sampled(models, knobs):
    """The allocator, chunking and cache hits are invisible in the output:
    greedy, and sampled with the same (seed, request, position) keys."""
    _, _, tm, tp = models
    prompts, lens = _overlap_prompts(tm.cfg)
    dyn = DynamicEngine(tm, EngineConfig(**_DYN, **knobs))
    static = Engine(tm, EngineConfig(**_DYN))
    out = dyn.serve(tp, prompts, lens, record_times=True)
    assert torch.equal(out["tokens"], static.serve(tp, prompts, lens)["tokens"])
    # record_times: one stamp per emitted token
    assert [len(t) for t in out["token_times"]] == out["lengths"].tolist()
    temp = np.array([0.0, 0.9, 1.2, 0.0, 0.7], np.float32)
    top_k = np.array([0, 0, 40, 0, 5], np.int32)
    a = dyn.serve(tp, prompts, lens, temperature=temp, top_k=top_k, seed=5)
    b = static.serve(tp, prompts, lens, temperature=temp, top_k=top_k, seed=5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["lengths"], b["lengths"])


def test_arrivals_gate_admission_without_moving_tokens(models):
    """Arrival-gated admission (the engine idles until the next arrival when
    nothing runs): the same greedy tokens, and no request's first token is
    stamped before it arrived."""
    _, _, tm, tp = models
    prompts, lens = _overlap_prompts(tm.cfg)
    eng = DynamicEngine(tm, EngineConfig(prefill_chunk=8, prefix_cache=True, **_DYN))
    want = eng.serve(tp, prompts, lens)
    arrivals = np.array([0.0, 0.0, 0.05, 0.3, 0.3])
    got = eng.serve(tp, prompts, lens, arrivals=arrivals, record_times=True)
    assert torch.equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["arrivals"], arrivals)
    first = np.array([t[0] for t in got["token_times"]])
    assert (first >= arrivals).all()
    eng.blocks.check_invariants()


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_prefill_pools_match_one_shot(models, chunk):
    """The paged cache a chunked admission builds is the one-shot cache: pos
    bit-identical, k/v within 2e-5 on every written row (rows at pos -1 are
    unspecified: one-shot admission invalidates them, chunks skip them).
    Fresh engines and the deterministic free list give the same page ids."""
    _, _, tm, tp = models
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, tm.cfg.vocab_size, (3, 16)).astype(np.int32)
    lens = np.asarray([16, 13, 7], np.int32)     # 13, 7: partial last pages
    a = DynamicEngine(tm, EngineConfig(prefill_chunk=chunk, **_DYN))
    b = DynamicEngine(tm, EngineConfig(**_DYN))
    assert torch.equal(a.serve(tp, prompts, lens)["tokens"],
                       b.serve(tp, prompts, lens)["tokens"])
    for key in a._pools["groups"]:
        pa, pb = a._pools["groups"][key]["attn"], b._pools["groups"][key]["attn"]
        assert torch.equal(pa["pos"], pb["pos"])
        live = pa["pos"] >= 0
        for leaf in ("k", "v"):
            torch.testing.assert_close(pa[leaf][live], pb[leaf][live],
                                       rtol=0, atol=2e-5)


def test_prefix_cache_on_off_and_warm_cache(models):
    """Cache on equals cache off, cold and warm; the warm serve shares
    strictly more; sampled draws do not move with cache hits."""
    _, _, tm, tp = models
    prompts, lens = _overlap_prompts(tm.cfg)
    on = DynamicEngine(tm, EngineConfig(prefill_chunk=4, prefix_cache=True, **_DYN))
    off = DynamicEngine(tm, EngineConfig(prefill_chunk=4, **_DYN))
    got_off = off.serve(tp, prompts, lens)
    got_on1 = on.serve(tp, prompts, lens)
    got_on2 = on.serve(tp, prompts, lens)
    for got in (got_on1, got_on2):
        assert torch.equal(got["tokens"], got_off["tokens"])
    assert got_off["prefill_cached"] == 0
    assert 0 < got_on1["prefill_cached"] < got_on2["prefill_cached"]
    temp = np.array([0.0, 1.0, 0.8, 0.0, 0.9], np.float32)
    assert torch.equal(on.serve(tp, prompts, lens, temperature=temp, seed=13)["tokens"],
                       off.serve(tp, prompts, lens, temperature=temp, seed=13)["tokens"])
    on.blocks.check_invariants()


def test_prefix_cache_eviction_under_pressure(models):
    """A pool for 2 live requests and 2 spare pages: a stream of disjoint
    prompts makes the radix tree evict LRU leaves on nearly every
    admission; outputs still equal the cache-off engine's."""
    _, _, tm, tp = models
    spec = tkv.build_spec(tm.cfg, _DYN["n_slots"],
                          _DYN["max_prompt_len"] + _DYN["max_gen_len"],
                          _DYN["page_size"])
    n_pages = 2 * spec.gp_cols + 2
    on = DynamicEngine(tm, EngineConfig(prefill_chunk=4, prefix_cache=True,
                                        n_pages=n_pages, **_DYN))
    off = DynamicEngine(tm, EngineConfig(prefill_chunk=4, n_pages=n_pages, **_DYN))
    rng = np.random.default_rng(31)
    prompts = rng.integers(0, tm.cfg.vocab_size, (6, 16)).astype(np.int32)
    lens = np.full((6,), 16, np.int32)
    assert torch.equal(on.serve(tp, prompts, lens)["tokens"],
                       off.serve(tp, prompts, lens)["tokens"])
    assert on.blocks.cache.n_evicted > 0
    on.blocks.check_invariants()
    assert on.blocks.galloc.n_allocated <= n_pages


def test_pool_for_one_request_queues_until_pages_free(models):
    """A pool that fits exactly one request: admissions wait head-of-line
    behind retirements and the pool drains completely."""
    _, _, tm, tp = models
    spec = tkv.build_spec(tm.cfg, _DYN["n_slots"],
                          _DYN["max_prompt_len"] + _DYN["max_gen_len"],
                          _DYN["page_size"])
    eng = DynamicEngine(tm, EngineConfig(n_pages=spec.gp_cols, **_DYN))
    prompts, lens = _prompts(tm.cfg, R=3, L=16, seed=6)
    want = Engine(tm, EngineConfig(**_DYN)).serve(tp, prompts, lens)
    assert torch.equal(eng.serve(tp, prompts, lens)["tokens"], want["tokens"])
    assert eng.blocks.galloc.n_free == spec.gp_cols
    eng.blocks.check_invariants()


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_request_larger_than_the_pool_raises(models):
    _, _, tm, tp = models
    spec = tkv.build_spec(tm.cfg, _DYN["n_slots"],
                          _DYN["max_prompt_len"] + _DYN["max_gen_len"],
                          _DYN["page_size"])
    eng = DynamicEngine(tm, EngineConfig(n_pages=spec.gp_cols - 1, **_DYN))
    prompts, lens = _prompts(tm.cfg, R=2, L=16, seed=6)
    with pytest.raises(PoolExhausted):
        eng.serve(tp, prompts, lens)


def test_admission_stall_raises(models):
    """Pages held by nobody the engine knows of (so no retirement will ever
    free them): the head of the queue can never be admitted."""
    _, _, tm, tp = models
    eng = DynamicEngine(tm, EngineConfig(**_DYN))
    for _ in range(eng.n_pages - eng.spec.gp_cols + 1):
        eng.blocks.galloc.alloc()
    prompts, lens = _prompts(tm.cfg, R=2, L=16, seed=6)
    with pytest.raises(RuntimeError, match="admission stalled"):
        eng.serve(tp, prompts, lens)


def test_engine_knob_validation(models):
    _, _, tm, _ = models
    for knob in (dict(prefix_cache=True), dict(prefill_chunk=4),
                 dict(n_pages=32), dict(n_window_pages=8),
                 dict(draft_k=3, adaptive_draft=True)):
        with pytest.raises(ValueError, match="DynamicEngine"):
            Engine(tm, EngineConfig(**_DYN, **knob))
    with pytest.raises(ValueError, match="multiple of page_size"):
        DynamicEngine(tm, EngineConfig(prefill_chunk=6, **_DYN))
    # speculation needs a drafter, and the adaptive length needs speculation
    for knob in (dict(draft_k=3), dict(draft_k=3, adaptive_draft=True)):
        with pytest.raises(ValueError, match="draft_k >= 1 and a draft_model"):
            DynamicEngine(tm, EngineConfig(**_DYN, **knob))
    with pytest.raises(ValueError, match="needs draft_k >= 1"):
        DynamicEngine(tm, EngineConfig(**_DYN, adaptive_draft=True))


# ---------------------------------------------------------------------------
# the multi-token paged decode forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 5])
def test_chunk_decode_forward_matches_reference_model(models, T):
    """A decode-mode forward of a T-token chunk per slot over the same paged
    pools (stale random bytes, permuted pages, one slot inactive and one row
    at -1): logits within atol = rtol = 1e-4 of the reference model's, the
    pools' positions equal and their written k/v within 2e-5."""
    jm, jp, tm, tp = models
    cfg = jm.cfg
    S, P, max_total = 3, 4, 24
    jspec = jkv.build_spec(cfg, S, max_total, P)
    tspec = tkv.build_spec(tm.cfg, S, max_total, P)
    jpools = jkv.init_pools(cfg, jspec)
    tpools = tkv.init_pools(tm.cfg, tspec, "cpu")
    rng = np.random.default_rng(7)
    N = tspec.n_global_pages
    tab = rng.permutation(N)[:S * tspec.gp_cols].reshape(S, -1).astype(np.int32)
    hist = [9, 0, 14]
    for key, jp_ in jpools["groups"].items():
        for leaf in ("k", "v"):
            a = rng.standard_normal(jp_["attn"][leaf].shape).astype(np.float32)
            jp_["attn"][leaf] = jnp.asarray(a)
            tpools["groups"][key]["attn"][leaf].copy_(torch.from_numpy(a))
        pos = np.full((cfg.n_groups, N, P), -1, np.int32)
        for s, h in enumerate(hist):
            for t in range(h):
                pos[:, tab[s, t // P], t % P] = t
        jp_["attn"]["pos"] = jnp.asarray(pos)
        tpools["groups"][key]["attn"]["pos"].copy_(torch.from_numpy(pos))
    positions = np.stack([np.arange(h, h + T) for h in hist]).astype(np.int32)
    positions[2, -1] = -1                      # a row past the chunk
    active = np.array([True, False, True])
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    jpaged = jkv.PagedState(global_table=jnp.asarray(tab), window_table=None,
                            active=jnp.asarray(active), page_size=P)
    want, jnew = jm.forward(jp, jnp.asarray(tokens),
                            positions=jnp.asarray(positions), mode="decode",
                            cache=jpools, paged=jpaged)
    tpaged = tkv.PagedState(global_table=torch.from_numpy(tab),
                            active=torch.from_numpy(active), page_size=P)
    ops.reset_launch_counts()
    got, _ = tm.forward(tp, torch.from_numpy(tokens),
                        positions=torch.from_numpy(positions), mode="decode",
                        cache=tpools, paged=tpaged)
    assert set(ops.launch_counts().values()) == {0}     # plain versions on the CPU
    live = np.broadcast_to(active[:, None], positions.shape) & (positions >= 0)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)
    for key in tpools["groups"]:
        jpool, tpool = jnew["groups"][key]["attn"], tpools["groups"][key]["attn"]
        jpos = np.asarray(jpool["pos"])
        np.testing.assert_array_equal(tpool["pos"].numpy(), jpos)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tpool[leaf].numpy()[jpos >= 0],
                                       np.asarray(jpool[leaf])[jpos >= 0], atol=2e-5)


def test_invalidate_pages_and_gather_slot_match_reference(models):
    """invalidate_pages skips ids at or past the pool (the reference's
    dropped out-of-bounds scatter); gather_slot is the reference's view."""
    jm, _, tm, _ = models
    cfg = jm.cfg
    jspec = jkv.build_spec(cfg, 2, 16, 4)
    tspec = tkv.build_spec(tm.cfg, 2, 16, 4)
    jpools = jkv.init_pools(cfg, jspec, n_global=11)
    tpools = tkv.init_pools(tm.cfg, tspec, "cpu", n_global=11)
    rng = np.random.default_rng(2)
    for key, jp_ in jpools["groups"].items():
        pos = rng.integers(-1, 30, jp_["attn"]["pos"].shape).astype(np.int32)
        k = rng.standard_normal(jp_["attn"]["k"].shape).astype(np.float32)
        jp_["attn"]["pos"], jp_["attn"]["k"] = jnp.asarray(pos), jnp.asarray(k)
        tpools["groups"][key]["attn"]["pos"].copy_(torch.from_numpy(pos))
        tpools["groups"][key]["attn"]["k"].copy_(torch.from_numpy(k))
    ids = np.array([3, 11, 0, 15, 7], np.int32)      # 11, 15: past the pool
    jnew = jkv.invalidate_pages(jpools, cfg, jnp.asarray(ids))
    tkv.invalidate_pages(tpools, tm.cfg, ids)
    row = np.array([7, 2, 10, 0], np.int32)
    for key in tpools["groups"]:
        jpool = jnew["groups"][key]["attn"]
        tpool = tpools["groups"][key]["attn"]
        np.testing.assert_array_equal(tpool["pos"].numpy(), np.asarray(jpool["pos"]))
        jview = jkv.gather_slot(jax.tree_util.tree_map(lambda a: a[1], jpool),
                                jnp.asarray(row))
        tview = tkv.gather_slot({n: t[1] for n, t in tpool.items()}, row)
        for name in ("k", "pos"):
            np.testing.assert_array_equal(tview[name].numpy(), np.asarray(jview[name]))
