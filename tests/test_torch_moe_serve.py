"""The MoE configs in the port against the reference: mixtral-8x22b (every
layer ``local_moe``, top-2) and llama4-scout (three ``local_moe`` layers and
one global ``moe`` layer a group, top-1: the routing without gate
renormalisation), both with untied embeddings.

On the reference's smokes in f32 with a random query projection and a
random readout (``zero_init_query=False``, ``zero_init_readout=False``: with
the µP default the readout starts at zero, every logit is exactly 0 and
greedy serving picks token 0 everywhere, which a test of its own holds);
the reference's weights move over by ``convert.params_from_numpy``.  The
configs, parameter counts and the weights' names and init statistics; the
full-sequence logits and prefill caches at f32 atol = rtol = 1e-4, under
``mup_table3`` too (the Table-3 rule, which refuses tied embeddings) and
the untied readout under amp; greedy serving token for token (equal
lengths and steps) through the static engine, ``DynamicEngine`` with
chunks, int8 pools (the near-tie rule of tests/test_torch_kv_int8.py) and
one speculative serve; the serve CLI on the reference CLI's own weights
and requests; B9's plan at mixtral's chunk and verify shapes; and
chip_smoke.py's routing checks (each row's request, a flip parting its
request alone, the held ceilings).  Prompts are drawn with numpy from
fixed seeds.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.meta import flatten_meta as j_flatten_meta  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving.engine import DynamicEngine as JDynamicEngine  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig  # noqa: E402

MOE_ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
OVER = dict(dtype="float32", zero_init_query=False, zero_init_readout=False)
LOGIT_TOL = 1e-4
TIE_GAP = 1e-5
# prompts up to 16 tokens past window 8 + page 4, 12 generated: the ring
# (3 pages of 4) wraps at admission and again while decoding
ECFG = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=12)
LENS = [16, 13, 7, 11, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **over):
    over = dict(OVER, **over)
    return jbuild(j_smoke(arch, **over)), tbuild(t_smoke(arch, **over), device="cpu")


def _to_torch(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


_MODELS = {}


@pytest.fixture(params=MOE_ARCHS)
def models(request):
    """(reference model, its params, port model, the same params) per arch."""
    arch = request.param
    if arch not in _MODELS:
        jm, tm = _pair(arch)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[arch] = (jm, jp, tm, _to_torch(jp))
    return _MODELS[arch]


def _prompts(V, lens, L=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (len(lens), L)).astype(np.int32),
            np.asarray(lens, np.int32))


# ---------------------------------------------------------------------------
# configs, counts and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_the_reference(arch, size):
    """Every field the port keeps equals the reference's, the MoE fields
    and zero_init_readout among them; the dropped ones are JAX lowering
    knobs."""
    t = (t_config if size == "full" else t_smoke)(arch)
    j = (j_config if size == "full" else j_smoke)(arch)
    kept = {f.name for f in dataclasses.fields(t)}
    for name in kept:
        assert getattr(t, name) == getattr(j, name), name
    assert {"n_experts", "top_k", "capacity_factor", "zero_init_readout"} <= kept
    assert not t.tie_embeddings and t.n_groups == j.n_groups
    assert "remat" not in kept


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_the_reference(arch):
    """param_count and active_param_count of every ported config (full
    and smoke) equal the reference's."""
    for get_t, get_j in ((t_config, j_config), (t_smoke, j_smoke)):
        t, j = get_t(arch), get_j(arch)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_mixtral_counts_and_the_serve_cli_refusal():
    """mixtral-8x22b: one layer 2,504,060,928 parameters with its two norm
    gains (experts 2,415,919,104, attention 88,080,384, router 49,152),
    embed + unembed 402,653,184; the serve CLI's byte count (from the
    metas) is param_count plus the norms' gains, so 56 layers in f32 (564
    GB) are refused on one card and 4 layers come to 41.7 GB."""
    cfg = t_config("mixtral-8x22b")
    one = cfg.replace(n_layers=1)
    emb = 2 * cfg.vocab_size * cfg.d_model
    assert emb == 402_653_184
    assert one.param_count() - emb + 2 * cfg.d_model == 2_504_060_928
    meta = tbuild(one, device="cpu").flat_meta
    n = {name: int(np.prod(m.infshape.shape)) for name, m in meta.items()}
    grp = "groups.0_local_moe"
    assert n[f"{grp}.mlp.wi"] + n[f"{grp}.mlp.wo"] == 2_415_919_104
    assert sum(v for k, v in n.items() if ".attn." in k) == 88_080_384
    assert n[f"{grp}.mlp.router"] == 49_152
    for layers in (4, 56):
        c = cfg.replace(n_layers=layers)
        got = tserve.weight_bytes(tbuild(c, device="cpu")) / 4
        assert 0 <= got - c.param_count() == (2 * layers + 1) * cfg.d_model
    assert 4 * cfg.param_count() > 80e9
    four = tserve.weight_bytes(tbuild(cfg.replace(n_layers=4), device="cpu"))
    assert 41.6e9 < four < 41.8e9


def test_weights_carry_over_by_name(models):
    """The port's params are the reference's tree by dotted name: the
    untied ``unembed`` and each layer's router and stacked experts."""
    jm, jp, tm, tp = models
    assert set(tp) == set(tm.flat_meta) and "unembed" in tp
    E, D, F = tm.cfg.n_experts, tm.cfg.d_model, tm.cfg.d_ff
    L = tm.cfg.n_groups
    for key in tm.meta["groups"]:
        assert tuple(tp[f"groups.{key}.mlp.router"].shape) == (L, D, E)
        assert tuple(tp[f"groups.{key}.mlp.wi"].shape) == (L, E, D, 2 * F)
        assert tuple(tp[f"groups.{key}.mlp.wo"].shape) == (L, E, F, D)
    for name, t in tp.items():
        assert tuple(t.shape) == tm.flat_meta[name].infshape.shape, name


# ---------------------------------------------------------------------------
# the model's logits and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 33])
def test_logits_match_reference(models, S):
    """Train and prefill logits, and the emitted caches (a ring of the last
    ``window`` tokens for the windowed layers)."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jl, jc = jm.forward(jp, jnp.asarray(toks), mode="prefill", cache_len=S + 4)
    tl, tc = tm.forward(tp, torch.from_numpy(toks), mode="prefill", cache_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for key, tcache in tc["groups"].items():
        jcache = jc["groups"][key]["attn"]
        np.testing.assert_array_equal(tcache["attn"]["pos"].numpy(), np.asarray(jcache["pos"]))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tcache["attn"][leaf].numpy(), np.asarray(jcache[leaf]),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_default_readout_starts_at_zero(arch):
    """Under µP with zero_init_readout (the default) the untied readout is
    zero: both packages' logits are exactly 0, on their own inits."""
    over = dict(dtype="float32")
    jm, tm = jbuild(j_smoke(arch, **over)), tbuild(t_smoke(arch, **over), device="cpu")
    jp, tp = jm.init(jax.random.PRNGKey(0)), tm.init(seed=0)
    assert tm.flat_meta["unembed"].init == "zeros" and not tp["unembed"].any()
    toks = np.random.default_rng(0).integers(0, 512, (2, 9)).astype(np.int32)
    assert not np.asarray(jm.forward(jp, jnp.asarray(toks))[0]).any()
    assert not tm.forward(tp, torch.from_numpy(toks))[0].any()
    # SP ignores the flag, as in the reference
    sp = t_smoke(arch, parametrization="sp")
    assert tbuild(sp, device="cpu").flat_meta["unembed"].init == "normal"


@pytest.mark.parametrize("zero_readout", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_statistics(arch, zero_readout):
    """The port's own init at 8x the smoke's width: unembed zeros (µP's
    default) or normal at the rule's init_std, and every router and
    expert tensor at its rule's init_std (within 5%), the rules equal to
    the reference's."""
    over = dict(d_model=384, d_ff=768, n_heads=8, zero_init_readout=zero_readout)
    tcfg, jcfg = t_smoke(arch, **over), j_smoke(arch, **over)
    tm, jm = tbuild(tcfg, device="cpu"), jbuild(jcfg)
    tp = tm.init(seed=0)
    jmeta = j_flatten_meta(jm.meta)
    for name, m in tm.flat_meta.items():
        rule, jrule = m.rule(tm.p13n), jmeta[name].rule(jm.p13n)
        assert rule.init_std == pytest.approx(jrule.init_std), name
        assert m.init == jmeta[name].init, name
        if name == "unembed" and zero_readout:
            assert m.init == "zeros" and not tp[name].any()
        elif name == "unembed" or ".mlp." in name:
            std = tp[name].double().std().item()
            assert std == pytest.approx(rule.init_std, rel=0.05), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_mup_table3_on_the_untied_smoke(arch):
    """The Table-3 rule accepts the untied configs and the port's logits
    match the reference's under it; both refuse a tied config."""
    jm, tm = _pair(arch, parametrization="mup_table3")
    jp = jm.init(jax.random.PRNGKey(1))
    tp = _to_torch(jp)
    tm.init(seed=0)                               # validate_config accepts it
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    tied = dict(OVER, parametrization="mup_table3", tie_embeddings=True)
    with pytest.raises(ValueError, match="tied"):
        jbuild(j_smoke(arch, **tied)).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="tied"):
        tbuild(t_smoke(arch, **tied), device="cpu").init(seed=0)


@pytest.mark.parametrize("amp", ["bf16", "int8"])
def test_untied_readout_under_amp(amp):
    """The untied readout through quant_matmul under amp (attention through
    the flash kernels' plain versions): the loss equals the reference's at
    tests/test_torch_gemma2.py's amp bars."""
    jm, tm = _pair("mixtral-8x22b", amp=amp)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = _to_torch(jp)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    want = jm.loss_fn(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3 if amp == "bf16" else 1e-4)


# ---------------------------------------------------------------------------
# both engines
# ---------------------------------------------------------------------------

def _same_serve(got, want, spec=False):
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert got["steps"] == int(want["steps"])
    if spec:
        assert (got["accepted"], got["proposed"]) == \
            (int(want["accepted"]), int(want["proposed"]))


def test_static_engine_matches_reference(models):
    """5 requests on 2 slots, prompts up to 16 tokens (past the 3-page
    ring: the admission keeps its reach only), 12 decode steps wrapping it
    again; each admission a one-shot prefill of the padded 16-token buffer
    (the MoE's capacity over S = 16), decode steps over S = 1."""
    jm, jp, tm, tp = models
    eng = Engine(tm, EngineConfig(**ECFG))
    assert eng.spec.wp_cols == 3
    prompts, lens = _prompts(jm.cfg.vocab_size, LENS)
    got = eng.serve(tp, prompts, lens)
    _same_serve(got, JEngine(jm, JEngineConfig(**ECFG)).serve(jp, prompts, lens))
    assert len(set(got["tokens"].reshape(-1).tolist())) > 3    # not a constant readout


@pytest.mark.parametrize("knobs", [dict(), dict(prefill_chunk=4, prefix_cache=True),
                                   dict(prefill_chunk=8)],
                         ids=["one_shot", "chunk4_prefix_cache", "chunk8"])
def test_dynamic_engine_matches_reference(models, knobs):
    """DynamicEngine against the reference's on a cold and a warm engine:
    tokens, lengths, steps; chunked admissions run the MoE over each
    chunk's own S (another capacity than a one-shot prefill's, so only the
    same mode is compared); the prefix cache requested on a windowed config
    shares nothing; a config with no global layer allocates its global
    pages on the host only (no global pool on the device), as the
    reference does."""
    jm, jp, tm, tp = models
    ours = DynamicEngine(tm, EngineConfig(**ECFG, **knobs))
    theirs = JDynamicEngine(jm, JEngineConfig(**ECFG, **knobs))
    assert ours.blocks.cache is None
    assert (ours.n_pages, ours.n_window_pages) == (theirs.n_pages, theirs.n_window_pages)
    assert set(ours._pools["groups"]) == set(theirs._pools["groups"])
    prompts, lens = _prompts(jm.cfg.vocab_size, LENS, seed=2)
    for _ in range(2):
        got, want = ours.serve(tp, prompts, lens), theirs.serve(jp, prompts, lens)
        _same_serve(got, want)
        assert got["prefill_cached"] == want["prefill_cached"] == 0
        ours.blocks.check_invariants()
    for key, pool in ours._pools["groups"].items():
        jpool = theirs._pools["groups"][key]["attn"]
        np.testing.assert_array_equal(pool["attn"]["pos"].numpy(), np.asarray(jpool["pos"]))


def _greedy_equal(jm, jp, prompts, lens, got, want):
    """Greedy tokens equal request by request, or the first difference is a
    near-tie of the reference's full-sequence forward (top-2 gap below
    TIE_GAP); lengths equal where no tie was met.  Returns the ties."""
    ties = 0
    for r in range(len(lens)):
        a = got["tokens"].numpy()[r, :int(got["lengths"][r])]
        b = np.asarray(want["tokens"])[r, :int(want["lengths"][r])]
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        if len(diff) == 0:
            assert len(a) == len(b), r
            continue
        j = int(diff[0])
        seq = np.concatenate([prompts[r, :lens[r]], b[:j]])[None]
        logits, _ = jm.forward(jp, jnp.asarray(seq))
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < TIE_GAP, (r, j, top2)
        ties += 1
    return ties


@pytest.mark.parametrize("engine", ["static", "dynamic_chunk4"])
def test_int8_pools_match_reference(models, engine):
    """int8 ring pools against the reference's int8 engines on the same
    weights (near-tie rule); with no tie, equal steps."""
    jm, jp, tm, tp = models
    arch = tm.cfg.name.replace("-smoke", "")
    arch = {"llama4-scout": "llama4-scout-17b-a16e"}.get(arch, arch)
    jm8, tm8 = _pair(arch, kv_dtype="int8")
    prompts, lens = _prompts(jm8.cfg.vocab_size, LENS, seed=4)
    if engine == "static":
        ours, theirs = Engine(tm8, EngineConfig(**ECFG)), JEngine(jm8, JEngineConfig(**ECFG))
    else:
        knobs = dict(prefill_chunk=4)
        ours = DynamicEngine(tm8, EngineConfig(**ECFG, **knobs))
        theirs = JDynamicEngine(jm8, JEngineConfig(**ECFG, **knobs))
    got, want = ours.serve(tp, prompts, lens), theirs.serve(jp, prompts, lens)
    if _greedy_equal(jm8, jp, prompts, lens, got, want) == 0:
        assert got["steps"] == int(want["steps"])


def test_speculative_serve_matches_reference(models):
    """The static engine with the µP proxy ``scaled(0.5)`` (an MoE drafter
    of its own) and draft_k 3: the verify runs the MoE over T = 4 a slot.
    Tokens, lengths, steps and accepted / proposed drafts equal the
    reference's, and the tokens the plain engine's."""
    jm, jp, tm, tp = models
    jd = jbuild(jm.cfg.scaled(0.5, min_d_head=8))
    jdp = jd.init(jax.random.PRNGKey(7))
    td = tbuild(tm.cfg.scaled(0.5, min_d_head=8), device="cpu")
    prompts, lens = _prompts(jm.cfg.vocab_size, LENS[:3], seed=3)
    ecfg = dict(ECFG, draft_k=3, max_gen_len=8)
    got = Engine(tm, EngineConfig(**ecfg), draft_model=td).serve(
        tp, prompts, lens, draft_params=_to_torch(jdp))
    want = JEngine(jm, JEngineConfig(**ecfg), draft_model=jd).serve(
        jp, prompts, lens, draft_params=jdp)
    _same_serve(got, want, spec=True)
    plain = Engine(tm, EngineConfig(**dict(ECFG, max_gen_len=8))).serve(tp, prompts, lens)
    assert torch.equal(got["tokens"], plain["tokens"])


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--static"], ["--prefill-chunk", "8"],
                                   ["--kv-dtype", "int8", "--static"]],
                         ids=["dynamic", "static", "chunk8", "int8_static"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_matches_reference(arch, extra, monkeypatch, capsys):
    """``serve --arch <moe> --smoke`` on both CLIs with the reference CLI's
    own weights (a random readout and query projection swapped in: the
    default readout starts at zero) and requests: the port's CLI, given the
    same weights and prompts, prints the same pool line (the port's names
    the ring's window beside it) and returns the same greedy tokens."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--prompt-len", "16",
            "--gen-len", "8", "--slots", "2", "--page-size", "4", "--mixed-lens", *extra]
    seen = {}
    real_init = JModel.init

    def init(self, rng, *a, **kw):
        p = real_init(self, rng, *a, **kw)
        rng_np = np.random.default_rng(0)
        p = jax.tree_util.tree_map(np.asarray, p)
        p["unembed"] = rng_np.standard_normal(p["unembed"].shape).astype(np.float32) * 0.2
        for grp in p["groups"].values():
            wq = grp["attn"]["wq"]
            grp["attn"]["wq"] = rng_np.standard_normal(wq.shape).astype(np.float32) * 0.2
        seen["params"] = p
        return jax.tree_util.tree_map(jnp.asarray, p)

    monkeypatch.setattr(JModel, "init", init)
    want = np.asarray(jserve.main(argv))
    jline = [ln for ln in capsys.readouterr().out.splitlines() if "paged KV pools" in ln]

    V, R, P = 512, 3, 16
    prompts = torch.from_numpy(np.asarray(jax.random.randint(jax.random.PRNGKey(1), (R, P),
                                                             0, V)).astype(np.int64))
    lens = torch.from_numpy(np.array(jax.random.randint(jax.random.PRNGKey(2), (R,),
                                                          max(1, P // 4), P + 1)))
    draws = iter([prompts, lens])
    monkeypatch.setattr(tserve.torch, "randint", lambda *a, **kw: next(draws))
    monkeypatch.setattr(TModel, "init",
                        lambda self, seed=0, dtype=None: params_from_numpy(seen["params"],
                                                                           device="cpu"))
    got = tserve.main([*argv, "--device", "cpu"])
    tline = [ln for ln in capsys.readouterr().out.splitlines() if "paged KV pools" in ln]
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.reshape(-1).tolist())) > 3
    assert [ln.replace(" (window 8)", "") for ln in tline] == jline


# ---------------------------------------------------------------------------
# B9's plan at mixtral's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bytes", [4, 1])
@pytest.mark.parametrize("shape", ["chunk of 256, 273-page ring", "verify T = 5, 258-page ring"])
def test_b9_plan_places_mixtral(kv_bytes, shape):
    """mixtral's 48/8 heads of 128 (a GQA group of 6): the dynamic engine's
    chunk of 256 over its 273-page ring (window 4,096 + 255 written ahead)
    and a speculative verify of draft_k + 1 = 5 over 4 slots' 258-page
    ring, f32 and int8 pools, on 132 and 114 SMs: the tile's rows (tq x 6)
    within 64, every tile placed within shared memory, the tiles balanced
    over T."""
    from repro_torch.kernels import decode_attention as da

    B, T, C = (1, 256, 273) if shape.startswith("chunk") else (4, 5, 258)
    for sms in (132, 114):
        plan = da.decode_multi_plan(B, 8, T, 6, 128, 16, C, kv_bytes, sms)
        assert plan.smem <= da.MAX_DYN_SMEM and plan.tq * 6 <= da.MULTI_MAX_ROWS
        assert plan.tiles == -(-T // plan.tq) and plan.tq == -(-T // plan.tiles)
        assert 1 <= plan.splits <= min(da.MAX_SPLITS, C)
        assert plan.tq == (10 if T == 256 else 5)
    spec = tkv.build_spec(t_config("mixtral-8x22b"), 4, 4608 + 32, 16, lookahead=255)
    assert spec.wp_cols == 273 and spec.gp_cols == 290
    assert tkv.build_spec(t_config("mixtral-8x22b"), 4, 4640, 16).wp_cols == 257
    assert tkv.build_spec(t_config("mixtral-8x22b"), 4, 4640, 16, lookahead=4).wp_cols == 258


# ---------------------------------------------------------------------------
# chip_smoke.py's routing checks, on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("engine", ["static", "dynamic_chunk4"])
def test_chip_smoke_routing_tags_each_rows_request(models, engine):
    """tag_requests gives every recorded forward the request of each row: a
    prefill's or a chunk's one request (every request admitted), a decode
    step's slots (-1 exactly where a slot is idle); two serves of one
    schedule then agree: no flip, no request parted, probabilities and
    logits equal."""
    cs = _chip_smoke()
    _, _, tm, tp = models
    Rec = cs.make_routing_recorder(TModel)
    prompts, lens = _prompts(tm.cfg.vocab_size, LENS)
    knobs = dict(prefill_chunk=4) if engine != "static" else {}
    make = Engine if engine == "static" else DynamicEngine
    serves = []
    for _ in range(2):
        m = Rec(tm.cfg, device="cpu")
        out = cs.tag_requests(make(m, EngineConfig(**ECFG, **knobs))).serve(tp, prompts, lens)
        serves.append((m, out))
    (a, out_a), (b, out_b) = serves
    admitted = set()
    for c in a.calls:
        assert len(c["req"]) == c["valid"].shape[0]
        if c["T"] == 1 and c["mode"] == "decode":
            assert [r >= 0 for r in c["req"]] == c["valid"][:, 0].tolist()
        else:
            admitted.update(c["req"])
    assert admitted == set(range(len(LENS)))
    route = cs.mx_routing("t", tm.cfg)(a, b, out_b)
    assert route["flips"] == [] and route["parted"] == {} and route["prob_noise"] == 0.0
    assert route["rows_compared"] > 0
    assert cs.compare_requests("t", a, b, out_a, out_b, 0.0, route["parted"])[:2] == (None, 0.0)


def test_chip_smoke_routing_flip_parts_one_request():
    """A routing flip at a near-tie parts its request alone: the other
    request's later logits and tokens are still held; a flip past the tie
    limit and probabilities past the ceiling fail."""
    cs = _chip_smoke()
    cfg = t_smoke("mixtral-8x22b")
    assert (cfg.n_experts, cfg.top_k) == (4, 2)

    def call(lg, idx, arg, rows):
        return dict(mode="decode", T=1, routes=[(lg, idx)], req=[7, 8], rows=rows,
                    valid=torch.ones(2, 1, dtype=torch.bool), arg=torch.tensor(arg),
                    active=torch.ones(2, dtype=torch.bool),
                    top2=torch.tensor([[1.0, 0.9], [1.0, 0.0]]))

    class Serve:
        def __init__(self, calls):
            self.calls = calls

    # request 7's experts 1 and 2 tie within 1e-7; request 8's are apart
    lg = torch.tensor([[[3.0, 1.0, 1.0 + 1e-7, 0.0]], [[2.0, 1.0, 0.0, 0.0]]])
    plain_idx, kern_idx = torch.tensor([[[0, 2]], [[0, 1]]]), torch.tensor([[[0, 1]], [[0, 1]]])
    zeros = torch.zeros(2, 4)
    plain = Serve([call(lg, plain_idx, [5, 6], zeros), call(lg, plain_idx, [5, 6], zeros)])
    # after its flip request 7 parts wholly (other experts, token, logits)
    far = torch.tensor([[[0.0, 5.0, 0.0, 9.0]], [[2.0, 1.0, 0.0, 0.0]]])
    kern = Serve([call(lg, kern_idx, [5, 6], zeros),
                  call(far, torch.tensor([[[3, 1]], [[0, 1]]]), [1, 6],
                       torch.tensor([[9.0, 0, 0, 0], [0, 0, 0, 0]]))])
    out_r = dict(steps=2, tokens=torch.arange(18).reshape(9, 2))
    out_k = dict(steps=2, tokens=out_r["tokens"].clone())
    out_k["tokens"][7] = 0
    route = cs.mx_routing("t", cfg)(kern, plain, out_r)
    assert route["parted"] == {7: 0} and len(route["flips"]) == 1
    assert route["flips"][0]["margin"] < cs.ROUTE_TIE and route["prob_noise"] == 0.0
    assert cs.compare_requests("t", kern, plain, out_k, out_r, cs.MX_LOGIT_TOL,
                               route["parted"]) == (0, 0.0, 0.0)
    # request 8 is still held: its logits, then its tokens
    kern.calls[1]["rows"] = torch.tensor([[9.0, 0, 0, 0], [1e-3, 0, 0, 0]])
    with pytest.raises(AssertionError, match="decode logits differ"):
        cs.compare_requests("t", kern, plain, out_k, out_r, cs.MX_LOGIT_TOL, route["parted"])
    kern.calls[1]["rows"] = zeros
    out_k["tokens"][8] = 0
    with pytest.raises(AssertionError, match="greedy tokens of requests"):
        cs.compare_requests("t", kern, plain, out_k, out_r, cs.MX_LOGIT_TOL, route["parted"])
    # a flip where the experts do not tie
    bad = Serve([call(lg, torch.tensor([[[0, 2]], [[0, 3]]]), [5, 6], zeros)] * 2)
    with pytest.raises(AssertionError, match="expert choice differs"):
        cs.mx_routing("t", cfg)(bad, plain, out_r)
    # probabilities past the ceiling on rows that did not flip
    moved = lg.clone()
    moved[1, 0, 3] += 1e-3
    with pytest.raises(AssertionError, match="router probabilities differ"):
        cs.mx_routing("t", cfg)(Serve([call(moved, plain_idx, [5, 6], zeros)] * 2), plain, out_r)
