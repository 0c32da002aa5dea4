"""The port's batched HP sweep (``repro_torch.core.tuning``, ``core.hp``,
``core.hpspace``'s sampling, ``core.coord_check.coord_check_batched``) and
B1-B4 over a candidate axis, against the reference and against itself.

- The HP space's draws, grids and refusals equal the reference's field by
  field under µP and u-µP; RuntimeHP has the reference's leaves.
- On smoke mup-gpt, the three candidates of the reference's
  ``test_transformer_equivalence_and_hp_threading``, 6 steps at 4 x 32: the
  batched engine equals the serial loop with every HP baked into the
  config, and the reference's ``train_proxy_batched`` on the same init
  (the reference's ``init_params`` at ``candidate_rngs(0, 3)[i]``, carried
  across by ``params_from_numpy``) and the same batches, at rtol 2e-3 (the
  reference's own tolerance).
- Pruning: a diverging candidate is frozen bit for bit and leaves its
  neighbour's curve as it was alone (rtol 1e-5, the reference's); a
  loss-factor prune keeps a finite frozen score; an all-pruned run exits
  early.
- ``coord_check_batched`` against the one-lr ``coord_check`` and against
  the reference's at the tolerances of ``tests/test_torch_coord_check.py``
  (RTOL 5e-3 / ATOL 1e-6, the threefry flag set as there).
- The vmap rules of B1-B4's autograd Functions: under ``torch.func.vmap``
  one call for all candidates (the kernel branch's wiring, its wrappers
  stood in for by their plain versions), the grouped plain versions equal
  G separate calls.  On the card (marked ``gpu``): the grouped kernels
  against their plain versions and a batched step's exact launches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import coord_check as jcoord  # noqa: E402
from repro.core import hp as jhp  # noqa: E402
from repro.core import hpspace as jhpspace  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.core.init import init_params as jinit_params  # noqa: E402
from repro.core.parametrization import resolve as jresolve  # noqa: E402
from repro.data.pipeline import make_pipeline  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import coord_check as tcoord  # noqa: E402
from repro_torch.core import hp as thp  # noqa: E402
from repro_torch.core import hpspace as thpspace  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.init import init_candidates  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.core.parametrization import resolve as tresolve  # noqa: E402
from repro_torch.kernels import cross_entropy as ce  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim.optimizer import Optimizer  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402

SWEEP_RTOL = 2e-3           # the reference's batched-vs-serial tolerance
ALONE_RTOL = 1e-5           # the reference's "does not poison" tolerance
CC_RTOL, CC_ATOL = 5e-3, 1e-6   # tests/test_torch_coord_check.py's
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
KW = dict(steps=6, batch_size=4, seq_len=32)
CANDIDATES = [dict(lr=5e-3), dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
              dict(lr=2e-2, sigma=2.0, alpha_attn=2.0, alpha_embed=0.5)]


@pytest.fixture(scope="module", autouse=True)
def _threefry_as_written_and_one_thread():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(n)


def _space(mod, name):
    return mod.umup_space() if name == "umup" else mod.mup_space()


def _fields(h):
    return {f.name: getattr(h, f.name) for f in dataclasses.fields(h)}


# ---------------------------------------------------------------------------
# (a) the HP space's sampling, grids and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space", ["mup", "umup"])
def test_sample_grid_and_search_match_reference(space):
    t, j = _space(thpspace, space), _space(jhpspace, space)
    for method in ("names", "runtime_names", "shared_names", "external_names"):
        assert getattr(t, method)() == getattr(j, method)(), method
    assert t.defaults() == j.defaults()
    assert [a.name for a in t.swept_axes()] == [a.name for a in j.swept_axes()]
    for seed in (0, 3):
        got, want = t.sample_n(16, seed), j.sample_n(16, seed)
        assert [_fields(h) for h in got] == [_fields(h) for h in want]
    got = t.grid(lr=(1e-3, 2e-3), alpha_output=(0.5, 1.0, 2.0))
    want = j.grid(lr=(1e-3, 2e-3), alpha_output=(0.5, 1.0, 2.0))
    assert [_fields(h) for h in got] == [_fields(h) for h in want]
    narrowed_t = t.with_search(lr=(1e-3, 1e-2), alpha_attn=(1.0, 4.0))
    narrowed_j = j.with_search(lr=(1e-3, 1e-2), alpha_attn=(1.0, 4.0))
    assert [_fields(h) for h in narrowed_t.sample_n(8, 1)] == \
        [_fields(h) for h in narrowed_j.sample_n(8, 1)]
    assert _fields(t.hparams(lr=3e-3)) == _fields(j.hparams(lr=3e-3))
    with pytest.raises(KeyError):
        t.hparams(nope=1.0)
    shim = ttuning.SearchSpace(t, lr=(1e-3,))
    assert shim.lr == (1e-3,) and shim.momentum == (0.0,)


def test_fixed_axis_refusals_match_reference():
    """u-µP fixes sigma: sweeping it is refused by with_search, grid and the
    sweep's validation, with the reference's messages; cfg.amp is not
    refused (the sweep runs under it as the reference's does)."""
    t, j = thpspace.umup_space(), jhpspace.umup_space()
    for call in (lambda s: s.with_search(sigma=(0.5,)), lambda s: s.grid(sigma=(0.5, 1.0))):
        with pytest.raises(ValueError) as got:
            call(t)
        with pytest.raises(ValueError) as want:
            call(j)
        assert str(got.value) == str(want.value)
    cfg = tsmoke("mup-gpt").replace(parametrization="umup")
    with pytest.raises(ValueError, match="fixed at 1.0"):
        ttuning.train_proxy_batched(cfg, [t.hparams(sigma=0.5)], device="cpu", **KW)
    with pytest.raises(ValueError, match="not applied by the batched engine"):
        ttuning.train_proxy_batched(tsmoke("mup-gpt"), [t.hparams(schedule="cosine")],
                                    device="cpu", **KW)
    with pytest.raises(ValueError, match="not vectorized"):
        ttuning.train_proxy_batched(tsmoke("mup-gpt"), [t.hparams(b1=0.8), t.hparams()],
                                    device="cpu", **KW)
    # a config's amp policy is no refusal: the bf16 sweep runs and matches
    # the reference's on its own init (tests/test_torch_sweep_amp.py holds
    # both policies at 4 x 128 tokens)
    hps = [t.hparams()]
    init = params_from_numpy(_reference_init(jsmoke("mup-gpt"), hps), device="cpu")
    got = ttuning.train_proxy_batched(tsmoke("mup-gpt").replace(amp="bf16"), hps, device="cpu",
                                      init_fn=lambda gens, hp: init, **KW)
    want = jtuning.train_proxy_batched(jsmoke("mup-gpt").replace(amp="bf16"), hps, **KW)
    np.testing.assert_allclose(got.curves, want.curves, rtol=SWEEP_RTOL)


# ---------------------------------------------------------------------------
# (b) RuntimeHP
# ---------------------------------------------------------------------------

def test_runtime_hp_leaves_and_stacking():
    assert tuple(f.name for f in dataclasses.fields(thp.RuntimeHP)) == jhp.RUNTIME_NAMES
    assert thp.RUNTIME_NAMES == jhp.RUNTIME_NAMES
    cfg = tsmoke("mup-gpt")
    assert thp.runtime_config_axes(cfg) == jhp.runtime_config_axes(jsmoke("mup-gpt"))
    space = thpspace.mup_space()
    cands = [space.hparams(lr=1e-3), space.hparams(lr=2e-3, lr_embed=5e-3)]
    stack = thp.stack_hparams(cands, device="cpu")
    want = jhp.stack_hparams(cands)
    for name in thp.RUNTIME_NAMES:
        got_leaf, want_leaf = getattr(stack, name), getattr(want, name)
        assert got_leaf.dtype == torch.float32 and got_leaf.shape == (2,)
        np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(want_leaf))
    # lr_embed=None follows the candidate's own lr; all None stays None
    assert stack.lr_embed.tolist() == pytest.approx([1e-3, 5e-3])
    assert thp.stack_hparams(cands[:1], device="cpu").lr_embed is None
    assert thp.n_candidates(stack) == 2
    one = thp.hp_at(stack, 1)
    assert float(one.lr) == pytest.approx(2e-3) and one.lr.ndim == 0
    with pytest.raises(ValueError):
        thp.stack_hparams([], device="cpu")
    # a pytree node whose None leaves vanish, so vmap maps the rest
    leaves, spec = torch.utils._pytree.tree_flatten(thp.stack_hparams(cands[:1], device="cpu"))
    assert len(leaves) == len(thp.RUNTIME_NAMES) - 1
    assert torch.utils._pytree.tree_unflatten(leaves, spec).lr_embed is None


# ---------------------------------------------------------------------------
# (c) the batched engine against the serial loop and the reference
# ---------------------------------------------------------------------------

def _candidates():
    space = thpspace.mup_space()
    return [space.hparams(**c) for c in CANDIDATES]


def _reference_init(jcfg, cands):
    """The reference engine's init: init_params at candidate_rngs(0, n)[i]
    with candidate i's sigma, as numpy, stacked on a leading axis."""
    model = jbuild(jcfg.replace(dtype="float32"))
    stacked = jax.vmap(lambda r, s: jinit_params(r, model.meta, model.p13n, sigma=s))(
        jtuning.candidate_rngs(0, len(cands)),
        jnp.asarray([h.sigma for h in cands], jnp.float32))
    return flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                        lambda x: isinstance(x, np.ndarray))


def test_batched_equals_serial_and_the_reference():
    cands = _candidates()
    cfg = tsmoke("mup-gpt")
    bat = ttuning.train_proxy_batched(cfg, cands, device="cpu", **KW)
    ser = ttuning.train_proxy_serial(cfg, cands, device="cpu", **KW)
    assert bat.active.all() and ser.active.all() and bat.steps_run == 6
    np.testing.assert_allclose(bat.curves, ser.curves, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(bat.losses, ser.losses, rtol=SWEEP_RTOL)

    # the reference's engine, on its own init carried across
    flat = _reference_init(jsmoke("mup-gpt"), cands)
    init = params_from_numpy(flat, device="cpu")
    got = ttuning.train_proxy_batched(cfg, cands, device="cpu",
                                      init_fn=lambda gens, hp: init, **KW)
    want = jtuning.train_proxy_batched(jsmoke("mup-gpt"), cands, **KW)
    np.testing.assert_allclose(got.curves, want.curves, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(got.losses, want.losses, rtol=SWEEP_RTOL)
    assert got.best_index == want.best_index
    # and the serial loop on the same init agrees with both
    ser_ref = ttuning.train_proxy_serial(cfg, cands, device="cpu",
                                         init_fn=lambda gens, hp: init, **KW)
    np.testing.assert_allclose(ser_ref.curves, want.curves, rtol=SWEEP_RTOL)


def test_per_candidate_init_draws_and_sigmas():
    """Candidate i draws from its own generator at its own sigma: the
    stacked init equals N separate inits, and candidates differ."""
    model = tbuild(tsmoke("mup-gpt"), device="cpu")
    gens = ttuning.candidate_generators(0, 3, device="cpu")
    stacked = init_candidates(gens, model.meta, model.p13n, [1.0, 0.5, 2.0])
    again = init_candidates(ttuning.candidate_generators(0, 3, device="cpu"), model.meta,
                            model.p13n, [1.0, 0.5, 2.0])
    for name, t in stacked.items():
        assert t.shape[0] == 3 and torch.equal(t, again[name])
    w = stacked["groups.0_attn.attn.wk"]
    assert not torch.equal(w[0], w[1])
    # sigma scales the init std: same generator seed, sigma 2 vs 1
    one = init_candidates(ttuning.candidate_generators(0, 3, device="cpu")[:1], model.meta,
                          model.p13n, [2.0])
    torch.testing.assert_close(one["groups.0_attn.attn.wk"][0], 2 * w[0])
    assert not ttuning.candidate_generators(1, 1, device="cpu")[0].initial_seed() == \
        gens[0].initial_seed()


# ---------------------------------------------------------------------------
# (d) pruning
# ---------------------------------------------------------------------------

def test_divergence_prunes_freezes_and_does_not_poison():
    space = thpspace.mup_space()
    cfg = tsmoke("mup-gpt")
    good = space.hparams(lr=5e-3)
    res = ttuning.train_proxy_batched(cfg, [good, space.hparams(lr=1e25)], device="cpu", **KW)
    assert res.active[0] and not res.active[1]
    assert np.isfinite(res.losses[0]) and np.isinf(res.losses[1])
    diverged_at = int(np.argmax(np.isinf(res.curves[:, 1])))
    assert np.isinf(res.curves[diverged_at:, 1]).all()
    assert res.best_index == 0
    alone = ttuning.train_proxy_batched(cfg, [good], device="cpu", **KW)
    np.testing.assert_allclose(res.curves[:, 0], alone.curves[:, 0], rtol=ALONE_RTOL)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_pruned_candidate_is_frozen_bit_for_bit():
    """The batched step by hand: once pruned, the candidate's params and
    Adam moments keep their bits and its loss reads +inf."""
    space = thpspace.mup_space()
    cfg = tsmoke("mup-gpt").replace(dtype="float32")
    model = tbuild(cfg, device="cpu")
    cands = [space.hparams(lr=5e-3), space.hparams(lr=1e25)]
    hp = thp.stack_hparams(cands, device="cpu")
    opt = Optimizer.create("adamw", 0.0, model.p13n, model.meta, schedule=constant())
    params = init_candidates(ttuning.candidate_generators(0, 2, device="cpu"), model.meta,
                             model.p13n, [1.0, 1.0])
    state = opt.init(params)
    active = torch.ones(2, dtype=torch.bool)
    step = ttuning.make_batched_step(lambda p, b, h: model.loss_fn(p, b, hp=h), opt)
    frozen = 0
    for batch in ttuning._proxy_batches(cfg, 5, 4, 32, 0, "cpu"):
        was = bool(active[1])
        before = {k: (v[1].clone(), state["mu"][k][1].clone(), state["nu"][k][1].clone())
                  for k, v in params.items()}
        params, state, loss, active = step(params, state, active, hp, batch)
        if not was:
            frozen += 1
            assert torch.isinf(loss[1])
            for k, (p, m, v) in before.items():
                assert _same_bits(params[k][1], p) and _same_bits(state["mu"][k][1], m) \
                    and _same_bits(state["nu"][k][1], v), k
    assert frozen >= 2 and bool(active[0])


def test_loss_factor_pruning_and_early_exit():
    cfg = tsmoke("mup-gpt").replace(dtype="float32")
    model = tbuild(cfg, device="cpu")
    space = thpspace.mup_space()
    opt = Optimizer.create("adamw", 0.0, model.p13n, model.meta, schedule=constant())
    init = lambda gens, hp: init_candidates(gens, model.meta, model.p13n,  # noqa: E731
                                            hp.sigma.tolist())
    loss = lambda p, b, h: model.loss_fn(p, b, hp=h)  # noqa: E731
    batches = ttuning._proxy_batches(cfg, 12, 4, 32, 0, "cpu")
    # candidate 1's lr is ~zero: its loss stays at init level while candidate
    # 0 trains, so a tight factor prunes it at the check step
    hp = thp.stack_hparams([space.hparams(lr=2e-2), space.hparams(lr=1e-8)], device="cpu")
    out = ttuning.batched_train(init, loss, opt, hp, batches, prune_factor=1.05,
                                prune_every=8)
    assert out["active"][0] and not out["active"][1]
    # pruned-for-slowness keeps its frozen (finite) EMA score; its later
    # losses read +inf
    assert np.isfinite(out["losses"][1]) and out["losses"][1] > out["losses"][0]
    assert np.isinf(out["curves"][8:, 1]).all() and np.isfinite(out["curves"][:8, 1]).all()
    # every candidate diverges: the run stops before its last batch
    hp = thp.stack_hparams([space.hparams(lr=1e30), space.hparams(lr=1e30)], device="cpu")
    seen = []
    out = ttuning.batched_train(init, loss, opt, hp, batches,
                                stream=lambda t, lf, act: seen.append(t))
    assert out["steps_run"] < len(batches) and not out["active"].any()
    assert seen == list(range(out["steps_run"])) and np.isinf(out["losses"]).all()


# ---------------------------------------------------------------------------
# (e) the batched coord check
# ---------------------------------------------------------------------------

WIDTHS, LRS, CC_STEPS = (1.0, 2.0), (1e-3, 1e-2, 1e-1), 2


def _cc_factories():
    jbase = jsmoke("mup-gpt").replace(dtype="float32", n_layers=2,
                                      zero_init_readout=False, zero_init_query=False)
    tbase = tsmoke("mup-gpt").replace(dtype="float32", n_layers=2, zero_init_query=False)

    def jmake(i):
        model = jbuild(jbase.scaled(WIDTHS[i]))
        return (model.init(jax.random.PRNGKey(0)), model.meta,
                lambda p, b: model.loss_fn(p, b, collect_acts=True))

    def tmake(i):
        jparams = jbuild(jbase.scaled(WIDTHS[i])).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        model = tbuild(tbase.scaled(WIDTHS[i]), device="cpu")
        return params, model.meta, lambda p, b: model.loss_fn(p, b, collect_acts=True)

    pipe = make_pipeline(256, 32, 8, seed=0)
    raw = [pipe.batch(t) for t in range(CC_STEPS)]
    return (jmake, [{k: jnp.asarray(v) for k, v in b.items()} for b in raw],
            tmake, [{k: torch.from_numpy(v) for k, v in b.items()} for b in raw])


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for w in want:
        for t, (g, r) in enumerate(zip(got[w], want[w])):
            assert sorted(g) == sorted(r), (what, w, t)
            for k in r:
                np.testing.assert_allclose(np.asarray(g[k]), np.asarray(r[k]), rtol=CC_RTOL,
                                           atol=CC_ATOL, err_msg=f"{what} w={w} t={t} {k}")


def test_coord_check_batched_matches_one_lr_runs_and_the_reference():
    jmake, jb, tmake, tb = _cc_factories()
    widths = list(range(len(WIDTHS)))
    got = tcoord.coord_check_batched(tmake, widths, tb, tresolve("mup"), lrs=LRS)
    assert list(got.lrs) == list(LRS)
    for i, lr in enumerate(LRS):
        one = tcoord.coord_check(tmake, widths, tb, tresolve("mup"), lr=lr)
        _close(got.candidate_view(i).records, one.records, f"candidate {i}")
    want = jcoord.coord_check_batched(jmake, widths, jb, jresolve("mup"), lrs=LRS)
    _close(got.records, want.records, "reference")
    # keyed by d_model, the slopes read the candidate asked for
    got.records = {64 * int(WIDTHS[i]): v for i, v in got.records.items()}
    for i in range(len(LRS)):
        assert got.growth("logits.delta", candidate=i) == pytest.approx(
            got.candidate_view(i).growth("logits.delta"))


# ---------------------------------------------------------------------------
# (f) B1-B4 over a candidate axis: the vmap rules
# ---------------------------------------------------------------------------

def _norm_inputs(G=3, rows=10, D=48, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((3 * rng.standard_normal((G, rows, D))).astype(np.float32))
    g = torch.from_numpy((0.5 * rng.standard_normal((G, D))).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((G, rows, D)).astype(np.float32))
    return x, g, dy


def test_grouped_plain_versions_equal_separate_calls_under_vmap():
    x, g, dy = _norm_inputs()
    lx, lg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    y = torch.func.vmap(lambda a, b: ops.fused_rmsnorm(a, b))(lx, lg)
    dx, dg = torch.autograd.grad(y, (lx, lg), dy)
    for i in range(x.shape[0]):
        ax, ag = x[i].clone().requires_grad_(True), g[i].clone().requires_grad_(True)
        yi = ops.fused_rmsnorm(ax, ag)
        assert torch.equal(y[i], yi)
        dxi, dgi = torch.autograd.grad(yi, (ax, ag), dy[i])
        torch.testing.assert_close(dx[i], dxi, **GRAD_TOL)
        torch.testing.assert_close(dg[i], dgi, **GRAD_TOL)
    # the grouped plain versions themselves, against G calls of the (D,) form
    want = [ref.rmsnorm_bwd_ref(x[i], g[i], dy[i]) for i in range(3)]
    got = ref.rmsnorm_bwd_ref(x, g, dy)
    assert got[1].shape == (3, 48)
    torch.testing.assert_close(got[0], torch.stack([w[0] for w in want]), **GRAD_TOL)
    torch.testing.assert_close(got[1], torch.stack([w[1] for w in want]), **GRAD_TOL)
    assert torch.equal(ref.rmsnorm_ref(x, g), torch.stack(
        [ref.rmsnorm_ref(x[i], g[i]) for i in range(3)]))


@pytest.fixture
def kernel_branch(monkeypatch):
    """ops' kernel branch on the CPU: resolve_impl says "kernel" and the
    CUDA wrappers are stood in for by their plain versions, recording the
    shapes they are handed."""
    seen = {"fwd": [], "bwd": [], "ce_fwd": [], "ce_bwd": []}

    def fwd(x, gain, eps=1e-6):
        seen["fwd"].append((tuple(x.shape), tuple(gain.shape)))
        return ref.rmsnorm_ref(x, gain, eps)

    def bwd(x, gain, dy, eps=1e-6):
        seen["bwd"].append((tuple(x.shape), tuple(gain.shape)))
        return ref.rmsnorm_bwd_ref(x, gain, dy, eps)

    def ce_fwd(logits, labels):
        seen["ce_fwd"].append(tuple(logits.shape))
        return ref.softmax_cross_entropy_ref(logits, labels)

    def ce_bwd(logits, labels, lse, g):
        seen["ce_bwd"].append(tuple(logits.shape))
        return ref.softmax_cross_entropy_bwd_ref(logits, labels, lse, g)

    monkeypatch.setattr(ops, "resolve_impl", lambda impl, x: "kernel")
    monkeypatch.setattr(rn, "rmsnorm", fwd)
    monkeypatch.setattr(rn, "rmsnorm_bwd", bwd)
    monkeypatch.setattr(ce, "ce_fwd", ce_fwd)
    monkeypatch.setattr(ce, "ce_bwd", ce_bwd)
    return seen


def test_vmap_rules_make_one_call_for_all_candidates(kernel_branch):
    x, g, dy = _norm_inputs()
    lx, lg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    y = torch.func.vmap(lambda a, b: ops.fused_rmsnorm(a, b))(lx, lg)
    torch.autograd.grad(y, (lx, lg), dy)
    assert kernel_branch["fwd"] == [((3, 10, 48), (3, 48))]
    assert kernel_branch["bwd"] == [((3, 10, 48), (3, 48))]
    # a shared gain stays (D,); an unbatched x is broadcast to the candidates
    torch.func.vmap(lambda a: ops.fused_rmsnorm(a, g[0]))(x)
    torch.func.vmap(lambda b: ops.fused_rmsnorm(x[0], b))(g)
    assert kernel_branch["fwd"][1:] == [((3, 10, 48), (48,)), ((3, 10, 48), (3, 48))]
    # no gradient wanted: still one call through the rule
    with torch.no_grad():
        torch.func.vmap(lambda a, b: ops.fused_rmsnorm(a, b))(x, g)
    assert len(kernel_branch["fwd"]) == 4

    # B3/B4: the candidate axis folds into the rows, labels shared
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 2, 5, 11)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, 11, (2, 5)))
    ll = logits.clone().requires_grad_(True)
    losses = torch.func.vmap(lambda t: ops.softmax_cross_entropy(t, labels))(ll)
    (dl,) = torch.autograd.grad(losses.sum(), ll)
    assert kernel_branch["ce_fwd"] == [(30, 11)] and kernel_branch["ce_bwd"] == [(30, 11)]
    for i in range(3):
        li = logits[i].clone().requires_grad_(True)
        want = ops.softmax_cross_entropy(li, labels, impl="ref")
        torch.testing.assert_close(losses[i], want, rtol=0, atol=2e-5)
        torch.testing.assert_close(dl[i], torch.autograd.grad(want.sum(), li)[0], **GRAD_TOL)


def test_batched_step_calls_each_kernel_once_a_step(kernel_branch):
    """A batched step of N candidates through the model: 2 x layers + 1
    norms forward and backward, one cross entropy each way, whatever N."""
    cfg = tsmoke("mup-gpt")
    norms = 2 * cfg.n_layers + 1
    for n in (1, 3):
        for k in kernel_branch:
            kernel_branch[k].clear()
        ttuning.train_proxy_batched(cfg, _candidates()[:n], device="cpu", steps=2,
                                    batch_size=2, seq_len=16)
        assert len(kernel_branch["fwd"]) == len(kernel_branch["bwd"]) == 2 * norms
        assert all(gs == (n, cfg.d_model) for _, gs in kernel_branch["fwd"])
        assert kernel_branch["ce_fwd"] == kernel_branch["ce_bwd"] == [(n * 32, cfg.vocab_size)] * 2


def test_optimizer_per_candidate_lr_and_freeze():
    """update(lr=(N,) tensor) equals N scalar-lr updates; active=False keeps
    a candidate's moments' bits."""
    model = tbuild(tsmoke("mup-gpt"), device="cpu")
    gens = ttuning.candidate_generators(0, 2, device="cpu")
    params = init_candidates(gens, model.meta, model.p13n, [1.0, 1.0])
    grads = init_candidates(ttuning.candidate_generators(5, 2, device="cpu"), model.meta,
                            model.p13n, [1.0, 1.0])
    lrs, les = torch.tensor([1e-3, 3e-2]), torch.tensor([2e-3, 1e-2])
    opt = Optimizer.create("adamw", 0.0, model.p13n, model.meta, schedule=constant())
    state = opt.init(params)
    upd, state = opt.update(grads, state, params, lr=lrs, lr_embed=les)
    for i in range(2):
        one = Optimizer.create("adamw", float(lrs[i]), model.p13n, model.meta,
                               schedule=constant(), lr_embed=float(les[i]))
        p_i = {k: v[i] for k, v in params.items()}
        u_i, s_i = one.update({k: v[i] for k, v in grads.items()}, one.init(p_i), p_i)
        for k in params:
            torch.testing.assert_close(upd[k][i], u_i[k], rtol=1e-6, atol=1e-12)
            assert torch.equal(state["mu"][k][i], s_i["mu"][k])
    mu = {k: v.clone() for k, v in state["mu"].items()}
    nu = {k: v.clone() for k, v in state["nu"].items()}
    _, state = opt.update(grads, state, params, lr=lrs, active=torch.tensor([True, False]))
    for k in params:
        assert torch.equal(state["mu"][k][1], mu[k][1]) and torch.equal(state["nu"][k][1], nu[k][1])
        if grads[k][0].any():
            assert not torch.equal(state["mu"][k][0], mu[k][0]), k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("D", [48, 256, 1030])
def test_grouped_kernels_match_plain_on_card(groups, D):
    _card()
    rng = np.random.default_rng(groups + D)
    x = torch.from_numpy((3 * rng.standard_normal((16, 64, D))).astype(np.float32)).cuda()
    g = torch.from_numpy((0.5 * rng.standard_normal((groups, D))).astype(np.float32)).cuda()
    dy = torch.randn_like(x)
    n0, b0 = rn.grouped_launches, rn.bwd_grouped_launches
    y = rn.rmsnorm(x, g)
    dx, dg = rn.rmsnorm_bwd(x, g, dy)
    assert (rn.grouped_launches, rn.bwd_grouped_launches) == (n0 + 1, b0 + 1)
    torch.testing.assert_close(y, ref.rmsnorm_ref(x, g), rtol=0, atol=2e-5)
    want = ref.rmsnorm_bwd_ref(x, g, dy)
    torch.testing.assert_close(dx, want[0], **GRAD_TOL)
    torch.testing.assert_close(dg, want[1], **GRAD_TOL)
    assert torch.equal(rn.rmsnorm_bwd(x, g, dy)[1], dg)
    xs = x.reshape(groups, -1, D)
    assert torch.equal(y, torch.stack([rn.rmsnorm(xs[i], g[i]) for i in range(groups)])
                       .reshape(x.shape))


@pytest.mark.gpu
def test_batched_step_launches_on_card():
    _card()
    cfg = tsmoke("mup-gpt")
    ops.reset_launch_counts()
    ttuning.train_proxy_batched(cfg, _candidates(), device="cuda", **KW)
    counts = ops.launch_counts()
    norms = (2 * cfg.n_layers + 1) * KW["steps"]
    assert counts["rmsnorm_grouped"] == counts["rmsnorm_bwd_grouped"] == norms
    assert counts["ce_fwd"] == counts["ce_bwd"] == KW["steps"]
    assert counts["rmsnorm"] == counts["rmsnorm_bwd"] == 0
