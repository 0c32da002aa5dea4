"""The serving engines with observability attached (``obs=ServeObs(...)``)
against the same engines without it and against the reference's engines
with theirs, on the smoke smollm's reference weights (and its 0.5x proxy
as the drafter): the same tokens, the reference's counters, gauges and
histogram counts, its ``admission`` / ``retire`` event arguments and its
sequence of step phases, over two serves (the dynamic engine's pools and
prefix cache stay warm between them); the static engine's ``serve`` span;
and ``serve --obs``.

Wall-clock values (durations, tok/s, the histograms' sums) differ by
nature and are not compared.  The reference's ``serve_compile_count``
gauge has no counterpart: the port compiles no serve program.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.obs import PHASE_KERNELS, ServeObs, Tracer, parse_prometheus  # noqa: E402
from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig  # noqa: E402

_ECFG = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=6)
TIMED = ("serve_tokens_per_second",)
NOT_PORTED = {"serve_compile_count"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The reference, initialising under jax_threefry_partitionable=False
    while the module runs (the speculative tests' seeds)."""
    jax = pytest.importorskip("jax")
    import repro.obs as jobs
    from repro.configs import get_smoke_config
    from repro.models.model import build_model
    from repro.serving import engine as jengine

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield types.SimpleNamespace(jax=jax, obs=jobs, smoke=get_smoke_config, build=build_model,
                                Engine=jengine.Engine, DynamicEngine=jengine.DynamicEngine,
                                EngineConfig=jengine.EngineConfig)
    jax.config.update("jax_threefry_partitionable", old)


def _pair(jx, jcfg, tcfg, seed):
    jm = jx.build(jcfg)
    jp = jm.init(jx.jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, jp),
                                         device="cpu")


@pytest.fixture(scope="module")
def models(jx):
    """Target and its 0.5x proxy drafter, on the reference's weights, a
    random query projection (attention not uniform)."""
    over = dict(dtype="float32", zero_init_query=False)
    jcfg, tcfg = jx.smoke("smollm-135m").replace(**over), t_smoke("smollm-135m").replace(**over)
    return (_pair(jx, jcfg, tcfg, 0),
            _pair(jx, jcfg.scaled(0.5, min_d_head=8), tcfg.scaled(0.5, min_d_head=8), 7))


def _workload(V):
    """5 requests; rows 0-2 share an 8-token prefix (two pages)."""
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, V, (5, 16)).astype(np.int32)
    prompts[1:3, :8] = prompts[0, :8]
    lens = np.asarray([16, 13, 10, 7, 16], np.int32)
    return prompts, lens


VARIANTS = {
    "static": (False, {}, 0),
    "static_spec": (False, {}, 2),
    "dynamic_one_shot": (True, {}, 0),
    "dynamic_chunk4_prefix_cache": (True, dict(prefill_chunk=4, prefix_cache=True), 0),
    # a pool of two slots' pages: the second serve evicts cached prefixes
    "dynamic_prefix_cache_evicting": (True, dict(prefix_cache=True, n_pages=12), 0),
    "dynamic_spec_adaptive": (True, dict(prefill_chunk=8, prefix_cache=True,
                                         adaptive_draft=True), 3),
}


def _serves(cls, model, dmodel, ecfg, obs, params, dparams, prompts, lens):
    """Two serves on one engine."""
    eng = cls(model, ecfg, draft_model=dmodel, obs=obs)
    kw = {} if dmodel is None else {"draft_params": dparams}
    return [eng.serve(params, prompts, lens, **kw) for _ in range(2)]


def _values(snap):
    """The registry's deterministic values: counters and gauges but the
    timed ones, and the histograms' counts."""
    out = {}
    for name, v in snap.items():
        if isinstance(v, dict):
            out[name] = v["count"]
        elif name not in TIMED:
            out[name] = v
    return out


def _events(tracer):
    by = lambda name: [e["args"] for e in tracer.events if e["name"] == name]  # noqa: E731
    phases = [e["args"]["phase"] for e in tracer.events if e["name"] == "step"]
    return by("admission"), by("retire"), phases


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engines_with_obs_match_plain_and_the_reference(jx, models, variant):
    dynamic, knobs, k = VARIANTS[variant]
    (jm, jp, tm, tp), (jdm, jdp, tdm, tdp) = models
    prompts, lens = _workload(jm.cfg.vocab_size)
    ecfg = dict(_ECFG, draft_k=k, **knobs)
    tcls, jcls = (DynamicEngine, jx.DynamicEngine) if dynamic else (Engine, jx.Engine)
    spec = k > 0
    plain = _serves(tcls, tm, tdm if spec else None, EngineConfig(**ecfg), None, tp, tdp,
                    prompts, lens)
    obs = ServeObs(tracer=Tracer())
    ours = _serves(tcls, tm, tdm if spec else None, EngineConfig(**ecfg), obs, tp, tdp,
                   prompts, lens)
    jobs = jx.obs.ServeObs(tracer=jx.obs.Tracer())
    theirs = _serves(jcls, jm, jdm if spec else None, jx.EngineConfig(**ecfg), jobs, jp, jdp,
                     prompts, lens)
    for got, base, want in zip(ours, plain, theirs):
        assert torch.equal(got["tokens"], base["tokens"]) and got["steps"] == base["steps"]
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        assert got["steps"] == int(want["steps"])
    snap, jsnap = obs.metrics.snapshot(), jobs.metrics.snapshot()
    assert set(jsnap) - set(snap) == NOT_PORTED and set(snap) <= set(jsnap)
    assert _values(snap) == {k: v for k, v in _values(jsnap).items() if k not in NOT_PORTED}
    assert snap["serve_requests_total"] == 2 * len(lens)
    assert snap["serve_tokens_total"] == sum(int(o["lengths"].sum()) for o in ours)
    assert snap["serve_steps_total"] == sum(o["steps"] for o in ours)
    if spec:
        assert snap["spec_drafts_proposed_total"] == sum(o["proposed"] for o in ours) > 0
    if knobs.get("n_pages"):
        assert snap["prefix_cache_evicted_pages_total"] > 0
    parse_prometheus(obs.metrics.to_prometheus())
    assert _events(obs.tracer) == _events(jobs.tracer)
    if dynamic:
        steps = [e for e in obs.tracer.events if e["name"] == "step"]
        assert len(steps) == snap["serve_steps_total"]
        assert all(e["args"]["kernel"] == PHASE_KERNELS[e["args"]["phase"]] for e in steps)
        assert snap["serve_ttft_seconds"]["count"] == 2 * len(lens)
        if knobs.get("prefix_cache"):
            assert snap["prefill_cached_tokens_total"] == sum(o["prefill_cached"] for o in ours)
    else:
        spans = [e for e in obs.tracer.events if e["name"] == "serve"]
        assert [e["args"] for e in spans] == [dict(engine="static", requests=5)] * 2
        assert "serve_step_seconds" not in snap


def test_dynamic_record_times_feed_the_histograms(models):
    """record_times keeps its return shape, the stamps are monotonic and
    the same latencies land in the TTFT / ITL histograms."""
    (_, _, tm, tp), _ = models
    prompts, lens = _workload(tm.cfg.vocab_size)
    obs = ServeObs(tracer=Tracer())
    out = DynamicEngine(tm, EngineConfig(**_ECFG), obs=obs).serve(tp, prompts, lens,
                                                                  record_times=True)
    assert "token_times" in out and "arrivals" in out
    for ts in out["token_times"]:
        assert list(ts) == sorted(ts)
    snap = obs.metrics.snapshot()
    assert snap["serve_ttft_seconds"]["count"] == sum(1 for ts in out["token_times"] if ts)
    assert snap["serve_itl_seconds"]["count"] == sum(
        max(0, len(ts) - 1) for ts in out["token_times"])
    ttft = sorted(ts[0] - a for ts, a in zip(out["token_times"], out["arrivals"]) if ts)
    np.testing.assert_allclose(sorted(obs.metrics.get("serve_ttft_seconds").samples), ttft)


def test_serve_cli_obs_prints_prometheus_text(capsys):
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "12",
            "--gen-len", "4", "--slots", "2", "--page-size", "4"]
    plain = tserve.main(base)
    capsys.readouterr()
    for extra in (["--prefix-cache", "--prefill-chunk", "8"], ["--static"]):
        toks = tserve.main([*base, *extra, "--obs"])
        out = capsys.readouterr().out
        assert torch.equal(toks, plain)
        assert "[obs] " in out and " trace events" in out
        text = out[out.index("# HELP"):]
        fams = parse_prometheus(text)
        assert fams["serve_requests_total"] == 3
        assert 0 < fams["serve_tokens_total"] <= 3 * 4 and fams["serve_steps_total"] > 0
