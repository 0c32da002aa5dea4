"""gemma2 in the port against the reference: the configs, the model's logits
(local/global alternation, post-norms, softcaps, query-chunked attention
with a cut band), training (the loss and every gradient in f32, with and
without query chunks, and under ``amp="bf16"`` and ``amp="int8"``, where
attention takes the flash kernels' path; three f32 train steps), both
engines over a wrapped ring (f32 and int8 pools), speculative decoding with
a windowed target and drafter, and the serve CLI.

On the reference's own windowed fixture, ``get_smoke_config("gemma2-2b")``
with window 6 in f32 (``tests/test_serving.py``), with a random query
projection (``zero_init_query=False``) so that attention is not uniform
over the window; the reference's weights move over by
``convert.params_from_numpy``.  Logits at f32 atol = rtol = 1e-4; the
loss and gradients at tests/test_torch_train.py's f32 bars and
test_torch_amp*.py's amp bars (TRAIN_BARS); greedy
serving token for token, with equal lengths and step counts (int8 pools:
the near-tie rule of tests/test_torch_kv_int8.py).  Prompts are drawn with
numpy from fixed seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.optimizer import Optimizer as JOptimizer  # noqa: E402
from repro.serving.engine import DynamicEngine as JDynamicEngine  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_step  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim.optimizer import Optimizer as TOptimizer  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig  # noqa: E402

OVER = dict(dtype="float32", window_size=6, zero_init_query=False)
LOGIT_TOL = 1e-4
TIE_GAP = 1e-5
# prompts up to 16 tokens past window 6 + page 4, 20 generated: the ring
# (3-4 pages of 4) wraps at admission and again while decoding
ECFG = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=20)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(kv_dtype="", attn_chunk=None):
    over = dict(OVER, kv_dtype=kv_dtype)
    if attn_chunk:
        over["attn_chunk"] = attn_chunk
    return jbuild(j_smoke("gemma2-2b", **over)), tbuild(t_smoke("gemma2-2b", **over),
                                                        device="cpu")


@pytest.fixture(scope="module")
def models():
    jm, tm = _pair()
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompts(V, lens, L=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (len(lens), L)).astype(np.int32),
            np.asarray(lens, np.int32))


LENS = [16, 13, 7, 11, 2]


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma2-27b"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_the_reference(arch, size):
    """Every field the port keeps equals the reference's; the ones it drops
    are training-only knobs or kinds it does not run."""
    t = (t_config if size == "full" else t_smoke)(arch)
    j = (j_config if size == "full" else j_smoke)(arch)
    kept = {f.name for f in dataclasses.fields(t)}
    for name in kept:
        assert getattr(t, name) == getattr(j, name), name
    assert {"window_size", "attn_chunk", "post_attn_norm"} <= kept
    assert "remat" not in kept
    assert t.n_groups == j.n_groups and t.pattern == ("local", "attn")


def test_weights_carry_over_by_name(models):
    """The port's params are the reference's tree by dotted name, the
    post-norms' gains (ln1_post, ln2_post) included, and nothing else."""
    jm, jp, tm, tp = models
    assert set(tp) == set(tm.flat_meta)
    post = sorted(n for n in tp if "_post" in n)
    assert post == [f"groups.{i}_{k}.{g}" for i, k in enumerate(("local", "attn"))
                    for g in ("ln1_post", "ln2_post")]
    for name, t in tp.items():
        assert tuple(t.shape) == tm.flat_meta[name].infshape.shape, name


def test_weight_bytes_of_the_serve_cli():
    """The serve CLI's refusal on a card too small reads the weights' bytes
    from the metas: the reference's param count, plus the norms' gains."""
    for arch in ("gemma2-2b", "gemma2-27b"):
        n = tserve.weight_bytes(tbuild(t_config(arch), device="cpu")) / 4
        assert 0 <= n - j_config(arch).param_count() < 1e-3 * n


# ---------------------------------------------------------------------------
# the model's logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 48])
def test_logits_match_reference(models, S):
    """Train and prefill logits, and the emitted caches (a ring of the last
    ``window`` tokens for local layers), with attn_chunk cut to 16 on both
    sides: at S = 48 the local layers' band (16 + 6 keys) is cut."""
    _, jp, _, tp = models
    jm, tm = _pair(attn_chunk=16)
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jl, jc = jm.forward(jp, jnp.asarray(toks), mode="prefill", cache_len=S + 4)
    tl, tc = tm.forward(tp, torch.from_numpy(toks), mode="prefill", cache_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for key, tcache in tc["groups"].items():
        jcache = jc["groups"][key]["attn"]
        assert tcache["attn"]["k"].shape[2] == (6 if "local" in key else S + 4)
        np.testing.assert_array_equal(tcache["attn"]["pos"].numpy(), np.asarray(jcache["pos"]))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tcache["attn"][leaf].numpy(), np.asarray(jcache[leaf]),
                                       atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the model's knobs, and (loss tolerance, gradient tolerance, largest error
# as a share of the tensor's largest entry): tests/test_torch_train.py's f32
# bars and test_torch_amp.py's / test_torch_amp_int8.py's amp bars
TRAIN_MODES = {
    "f32": dict(),
    "f32, attn_chunk 8": dict(attn_chunk=8),
    "amp bf16": dict(amp="bf16"),
    "amp int8": dict(amp="int8"),
}
TRAIN_BARS = {
    "f32": (dict(atol=2e-5, rtol=1e-6), dict(atol=2e-4, rtol=1e-3), None),
    "f32, attn_chunk 8": (dict(atol=2e-5, rtol=1e-6), dict(atol=2e-4, rtol=1e-3), None),
    "amp bf16": (dict(rtol=1e-3), dict(atol=5e-2, rtol=5e-2), 0.02),
    "amp int8": (dict(rtol=1e-4), dict(atol=5e-2, rtol=5e-2), 0.02),
}


def _train_pair(**over):
    """(reference model, its params, port model, the same params) of the
    windowed fixture with ``over`` on both sides."""
    over = dict(OVER, **over)
    jm = jbuild(j_smoke("gemma2-2b", **over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(t_smoke("gemma2-2b", **over), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _train_batch(V, B=2, S=24, seed=0):
    """Tokens and labels with masked (-100) positions; S = 24 holds whole
    query chunks of 8 (the reference's attend_chunked asks S % chunk == 0)
    and runs past window 6."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, -1] = -100
    return {"tokens": toks, "labels": labels}


def _to(batch, side):
    if side == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.mark.parametrize("mode", sorted(TRAIN_MODES))
def test_loss_and_grads_match_reference(mode):
    """loss_fn and every gradient (post-norm gains, tied embedding, both
    kinds of layer) against the reference's jit(value_and_grad(loss_fn)),
    called outside its sharding context.  Under amp both sides' attention
    takes the flash kernels' path (here their plain versions, the reference's
    interpret-mode contract) and the readout rounds or quantizes."""
    jm, jp, tm, tp = _train_pair(**TRAIN_MODES[mode])
    batch = _train_batch(jm.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    loss_tol, grad_tol, share = TRAIN_BARS[mode]
    np.testing.assert_allclose(float(tloss), float(jloss), **loss_tol)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    assert sorted(tgrads) == sorted(want)
    for name, w in want.items():
        g = tgrads[name].detach()
        torch.testing.assert_close(g, w, **grad_tol, msg=name)
        if share is not None:
            assert (g - w).abs().max().item() <= share * w.abs().max().item() + 1e-7, name


@pytest.mark.parametrize("amp", ["bf16", "int8"])
def test_amp_routes_every_layer_through_flash_attention(amp, monkeypatch):
    """Under amp every layer's attention goes through ops.attention (B5-B7
    on the card) with the policy, the local layers with their window and
    the global ones with none, both with the softcap."""
    _, _, tm, tp = _train_pair(amp=amp)
    calls = []
    real = ops.attention

    def spy(*a, **kw):
        calls.append((kw["window"], kw["softcap"], kw["policy"]))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    tm.loss_fn(tp, _to(_train_batch(tm.cfg.vocab_size), "torch"))
    cap = tm.cfg.attn_softcap
    assert calls == [(6, cap, QuantPolicy(amp)), (0, cap, QuantPolicy(amp))] * 2


def test_three_train_steps_match_reference():
    """make_train_step (AdamW, linear schedule, clipping) for three f32 steps
    from the same weights on the same batches (tests/test_torch_train.py's
    test and bars: Adam's eps 1e-5, the losses and gradient norms within
    1e-4 relative, the weights at atol 2e-4 / rtol 1e-3)."""
    jm, jp, tm, tp = _train_pair()
    kw = dict(weight_decay=0.01, eps=1e-5)
    jopt = JOptimizer.create("adamw", 1e-2, jm.p13n, jm.meta,
                             schedule=jsched.linear_decay(3, warmup_steps=1), **kw)
    topt = TOptimizer.create("adamw", 1e-2, tm.p13n, tm.meta,
                             schedule=tsched.linear_decay(3, warmup_steps=1), **kw)
    jstep = jax.jit(jmake_step(jm, jopt))
    tstep = tmake_step(tm, topt)
    pipe = tpipeline(jm.cfg.vocab_size, 24, 2, seed=3)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for t in range(3):
        b = pipe.batch(t)
        jp, jstate, jm_ = jstep(jp, jstate, _to(b, "jax"))
        tp, tstate, tm_ = tstep(tp, tstate, _to(b, "torch"))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]),
                                   rtol=1e-4)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(tp[name].detach().numpy(), w.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("S", [12, 48])
def test_float64_forward_matches_reference(models, S, monkeypatch):
    """A float64 forward (plain versions only: what the card's f32 serve is
    measured against) feeds every norm f64, reads out the rows it is given,
    and lies within LOGIT_TOL of the reference's f32 logits."""
    jm, jp, _, tp = models
    tm64 = tbuild(t_smoke("gemma2-2b", **dict(OVER, dtype="float64", attn_chunk=16)),
                  device="cpu", impl="ref")
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    seen, fused = set(), ops.fused_rmsnorm
    monkeypatch.setattr(ops, "fused_rmsnorm",
                        lambda x, g, **kw: seen.add(x.dtype) or fused(x, g, **kw))
    p64 = {k: v.double() for k, v in tp.items()}
    got, _ = tm64.forward(p64, torch.from_numpy(toks))
    assert seen == {torch.float64}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    rows = torch.tensor([S // 3, S - 1])
    part, _ = tm64.forward(p64, torch.from_numpy(toks), readout=rows)
    torch.testing.assert_close(part, got[:, rows], atol=1e-12, rtol=0)


@pytest.mark.parametrize("fn", ["rmsnorm", "rotate", "attend"])
def test_plain_versions_keep_float64(fn):
    """B1's plain version, the rotary rotation and plain attention compute
    in f64 on float64 inputs (in f32 on f32 and bf16 ones): equal to the
    formula in f64 far below f32's rounding."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, rope

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 4, 8, generator=g, dtype=torch.float64)
    if fn == "rmsnorm":
        gain = torch.randn(8, generator=g, dtype=torch.float64)
        got = ref.rmsnorm_ref(x, gain)
        want = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1 + gain)
    elif fn == "rotate":
        cos, sin = rope.rope_cos_sin(torch.arange(5)[None].expand(2, 5), 8)
        got = rope.rotate(x, cos, sin)
        c, s = cos.double(), sin.double()
        want = torch.cat([x[..., :4] * c - x[..., 4:] * s, x[..., 4:] * c + x[..., :4] * s], -1)
    else:
        k = torch.randn(2, 5, 2, 8, generator=g, dtype=torch.float64)
        v = torch.randn(2, 5, 2, 8, generator=g, dtype=torch.float64)
        mask = torch.ones(2, 5, 5, dtype=torch.bool).tril()
        got = attention.attend(x, k, v, mask, 0.3, attn_softcap=5.0)
        kk, vv = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
        s = 5.0 * torch.tanh(torch.einsum("bshd,bthd->bhst", x, kk) * 0.3 / 5.0)
        p = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), -1)
        want = torch.einsum("bhst,bthd->bshd", p, vv)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def test_engine_prefill_reads_out_one_row(models):
    """The engines' prefill: padding at position Pmax, the full-length
    cache of every layer, the band cut (Pmax 48, chunks of 16); reading out
    only the last prompt row gives that row of the full readout (up to the
    matmul's order of summation) and the reference's."""
    _, jp, _, tp = models
    jm, tm = _pair(attn_chunk=16)
    Pmax, plen = 48, 41
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (1, Pmax)).astype(np.int32)
    pos = np.where(np.arange(Pmax) < plen, np.arange(Pmax), Pmax)[None].astype(np.int32)
    jl, jc = jm.forward(jp, jnp.asarray(toks), positions=jnp.asarray(pos), mode="prefill",
                        cache_len=Pmax, full_cache=True)
    full, tc = tm.forward(tp, torch.from_numpy(toks), positions=torch.from_numpy(pos),
                          mode="prefill", cache_len=Pmax, full_cache=True)
    one, _ = tm.forward(tp, torch.from_numpy(toks), positions=torch.from_numpy(pos),
                        mode="prefill", cache_len=Pmax, full_cache=True,
                        readout=torch.tensor([plen - 1]))
    assert one.shape == (1, 1, jm.cfg.vocab_size)
    np.testing.assert_allclose(one[:, 0].numpy(), np.asarray(jl)[:, plen - 1],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the same row up to the logit matmul's order of summation
    torch.testing.assert_close(one[:, 0], full[:, plen - 1], atol=1e-5, rtol=1e-5)
    for key, tcache in tc["groups"].items():
        jcache = jc["groups"][key]["attn"]
        np.testing.assert_array_equal(tcache["attn"]["pos"].numpy(), np.asarray(jcache["pos"]))
        np.testing.assert_allclose(tcache["attn"]["k"].numpy(), np.asarray(jcache["k"]),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# both engines over a wrapped ring
# ---------------------------------------------------------------------------

def _same_serve(got, want, spec=False):
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert got["steps"] == int(want["steps"])
    if spec:
        assert (got["accepted"], got["proposed"]) == \
            (int(want["accepted"]), int(want["proposed"]))


def test_static_engine_matches_reference_over_a_wrapped_ring(models):
    """Mirrors the reference's test_engine_matches_oracle_windowed_ring_
    wraparound against its Engine: 5 requests on 2 slots, prompts up to 16
    tokens (past the ring's 12: the admission keeps its reach only), 20
    decode steps wrapping the 3-page ring again."""
    jm, jp, tm, tp = models
    eng = Engine(tm, EngineConfig(**ECFG))
    assert eng.spec.wp_cols == 3 and eng.wtable.shape == (2, 3)
    prompts, lens = _prompts(jm.cfg.vocab_size, LENS)
    ops.reset_launch_counts()
    got = eng.serve(tp, prompts, lens)
    assert set(ops.launch_counts().values()) == {0}       # plain versions on the CPU
    _same_serve(got, JEngine(jm, JEngineConfig(**ECFG)).serve(jp, prompts, lens))


@pytest.mark.parametrize("knobs", [dict(), dict(prefill_chunk=4, prefix_cache=True)],
                         ids=["one_shot", "chunk4_prefix_cache"])
def test_dynamic_engine_matches_reference_over_a_wrapped_ring(models, knobs):
    """Mirrors test_dynamic_chunked_matches_static_windowed against the
    reference's DynamicEngine: the same tokens, lengths and steps, on a cold
    and a warm engine; the prefix cache requested on a windowed config
    shares nothing (its ring pages are overwritten in place), and chunked
    admission lands the window writes on the one-shot path's tokens."""
    jm, jp, tm, tp = models
    ours = DynamicEngine(tm, EngineConfig(**ECFG, **knobs))
    theirs = JDynamicEngine(jm, JEngineConfig(**ECFG, **knobs))
    assert ours.blocks.cache is None and ours.blocks.wp_cols == theirs.spec.wp_cols
    assert ours.n_window_pages == theirs.n_window_pages
    prompts, lens = _prompts(jm.cfg.vocab_size, LENS, seed=2)
    for _ in range(2):
        got, want = ours.serve(tp, prompts, lens), theirs.serve(jp, prompts, lens)
        _same_serve(got, want)
        assert got["prefill_cached"] == want["prefill_cached"] == 0
        ours.blocks.check_invariants()
    static = Engine(tm, EngineConfig(**ECFG)).serve(tp, prompts, lens)
    assert torch.equal(got["tokens"], static["tokens"])
    for key, pool in ours._pools["groups"].items():
        jpool = theirs._pools["groups"][key]["attn"]
        np.testing.assert_array_equal(pool["attn"]["pos"].numpy(), np.asarray(jpool["pos"]))
        live = np.asarray(jpool["pos"]) >= 0
        for leaf in ("k", "v"):
            np.testing.assert_allclose(pool["attn"][leaf].numpy()[live],
                                       np.asarray(jpool[leaf])[live], atol=1e-5, rtol=1e-5)


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
def test_int8_ring_engines_match_reference(models, engine):
    """int8 ring pools on both engines against the reference's int8
    engines on the same weights (near-tie rule); with no tie, equal steps."""
    _, jp, _, tp = models
    jm8, tm8 = _pair(kv_dtype="int8")
    prompts, lens = _prompts(jm8.cfg.vocab_size, LENS, seed=4)
    if engine == "static":
        ours, theirs = Engine(tm8, EngineConfig(**ECFG)), JEngine(jm8, JEngineConfig(**ECFG))
    else:
        knobs = dict(prefill_chunk=4, prefix_cache=True)
        ours = DynamicEngine(tm8, EngineConfig(**ECFG, **knobs))
        theirs = JDynamicEngine(jm8, JEngineConfig(**ECFG, **knobs))
    got, want = ours.serve(tp, prompts, lens), theirs.serve(jp, prompts, lens)
    if _greedy_equal(jm8, jp, prompts, lens, got, want) == 0:
        assert got["steps"] == int(want["steps"])


# ---------------------------------------------------------------------------
# speculative decoding with a windowed target and drafter
# ---------------------------------------------------------------------------

def test_spec_windowed_ring_wraparound_matches_reference(models):
    """Mirrors the reference's test_spec_windowed_ring_wraparound: window 6,
    20 generated tokens, draft_k 3, with the µP proxy ``scaled(0.5)`` and
    with the target itself as drafters; the ring wraps while the verify and
    catch-up chunks write ahead of the committed position.  Tokens, lengths,
    steps and accepted / proposed drafts equal the reference's speculative
    Engine, and the tokens the plain engine's."""
    jm, jp, tm, tp = models
    dcfg_j, dcfg_t = jm.cfg.scaled(0.5, min_d_head=8), tm.cfg.scaled(0.5, min_d_head=8)
    jd = jbuild(dcfg_j)
    jdp = jd.init(jax.random.PRNGKey(7))
    td = tbuild(dcfg_t, device="cpu")
    tdp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jdp), device="cpu")
    prompts, _ = _prompts(jm.cfg.vocab_size, [12] * 4, L=12, seed=3)
    lens = np.asarray([12, 5, 9, 1], np.int32)
    ecfg = dict(n_slots=2, page_size=4, max_prompt_len=12, max_gen_len=20)
    plain = Engine(tm, EngineConfig(**ecfg)).serve(tp, prompts, lens)
    for (jdm, jdpar), (tdm, tdpar) in (((jd, jdp), (td, tdp)), ((jm, jp), (tm, tp))):
        eng = Engine(tm, EngineConfig(**ecfg, draft_k=3), draft_model=tdm)
        assert eng.dwtable is not None and eng.spec.wp_cols == 4   # window 6 + 3 ahead
        got = eng.serve(tp, prompts, lens, draft_params=tdpar)
        want = JEngine(jm, JEngineConfig(**ecfg, draft_k=3), draft_model=jdm).serve(
            jp, prompts, lens, draft_params=jdpar)
        _same_serve(got, want, spec=True)
        assert torch.equal(got["tokens"], plain["tokens"])


def test_dynamic_spec_windowed_matches_reference(models):
    """The dynamic engine's speculative path on the windowed model, chunks
    of 4 and the adaptive draft length, against the reference's."""
    jm, jp, tm, tp = models
    knobs = dict(ECFG, draft_k=3, prefill_chunk=4, adaptive_draft=True)
    prompts, lens = _prompts(jm.cfg.vocab_size, LENS, seed=5)
    got = DynamicEngine(tm, EngineConfig(**knobs), draft_model=tm).serve(
        tp, prompts, lens, draft_params=tp)
    want = JDynamicEngine(jm, JEngineConfig(**knobs), draft_model=jm).serve(
        jp, prompts, lens, draft_params=jp)
    _same_serve(got, want, spec=True)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma2-27b"])
def test_serve_cli_gemma2_smoke_on_cpu(arch, capsys):
    """``serve --arch gemma2-2b --smoke --device cpu`` (and 27b) exits 0 on
    both engines, with int8 pools and with a drafter; the pool line names
    the ring pages; every path gives the default path's greedy tokens."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "24", "--gen-len", "12", "--slots", "2", "--page-size", "4",
            "--mixed-lens"]
    toks = tserve.main(base)
    printed = capsys.readouterr().out
    assert tuple(toks.shape) == (3, 12) and "ring (window 8)" in printed
    for extra in (["--static"], ["--prefix-cache", "--prefill-chunk", "8"],
                  ["--draft-width", "0.5", "--draft-k", "3"]):
        assert torch.equal(tserve.main([*base, *extra]), toks), extra
    printed = capsys.readouterr().out
    assert "[serve] prefix cache: 0/" in printed   # sharing off on ring configs
    assert tuple(tserve.main([*base, "--kv-dtype", "int8", "--static"]).shape) == (3, 12)
    assert "paged KV pools (int8)" in capsys.readouterr().out
