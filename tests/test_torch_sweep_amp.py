"""HP sweeps and batched coord checks under a mixed-precision policy
(``cfg.amp`` "bf16" or "int8"): B5-B7 and the policy matmuls over a
candidate axis, against the reference and against themselves.

The reference vmaps whatever its model runs: under amp its attention goes
through the Pallas flash kernels (on the CPU through its plain attention),
so ``jax.vmap`` makes one more grid axis of each ``pallas_call``.  The port's
counterpart is the vmap rule of ``ops._FlashAttention`` (the candidate axis
folded into the batch: one call of B5, B6 and B7 for N candidates) and of
``quant.core._QuantMatmul`` (one batched ``kernel_dot``, scales per
candidate).

- (a) The folded plain flash versions (``ops.attention_plain_flash`` under
  ``torch.func.vmap``, N = 3, a scale per candidate as a swept alpha_attn
  gives it) against ``jax.vmap`` of the reference's interpret-mode
  ``ops.attention`` (128 x 128 blocks, ``jax.vjp``), GQA, window and
  softcap, in the f32, bf16 and int8 operand modes, at the tiers of
  ``tests/test_torch_amp.py`` and ``tests/test_torch_amp_int8.py``: f32
  forward atol 2e-5, gradients atol 2e-4 / rtol 1e-3; bf16 and int8 each
  output's max abs error within its tier (bf16: o 2e-2, gradients 5e-2;
  int8 5e-2) and its mean within 3e-5.
- (b) The vmap rules make one call of the kernel wrappers (stood in for by
  their plain versions, as ``tests/test_torch_sweep.py``'s ``kernel_branch``
  does) for N candidates, for every ``in_dims`` combination; each
  candidate's slice equals a call on that candidate alone bit for bit, and
  a shared operand's gradient equals the sum of the per-candidate ones.
  A shared int8 ``w`` folded into x's rows would pool the candidates'
  scales: that control differs.
- (c) ``train_proxy_batched`` under amp on the reference's init against the
  reference's, three steps at 4 x 128 (the reference's 128-tiles apply):
  the first step's losses at rtol 1e-4 (``tests/test_torch_amp_int8.py``'s
  bar for one int8 ``loss_fn``), the curves and scores at rtol 2e-3, the
  tolerance ``tests/test_torch_sweep.py`` holds the f32 sweep to against
  the reference.  Measured: bf16 within 1.1e-4, int8 within 1.8e-3, at
  the third step of the candidate at lr 2e-2, sigma 2, alpha_attn 2.  That
  candidate's first int8 loss is 1.6e-5 from the reference's, as far as a
  1-ulp jitter of its weights moves it (int8 bytes on a half step flip),
  and Adam at the engine's eps 1e-8 grows it step by step (the three-step
  test of ``tests/test_torch_amp_int8.py`` runs eps 1e-5 and a warm-up,
  and holds 1e-3).  (d) Batched against serial at the reference's rtol
  2e-3; the legacy ``train_proxy`` and ``random_search`` under amp run.
- (e) Under int8 a diverging candidate (lr 1e25) is pruned and frozen bit
  for bit, and its neighbour's curve stays within rtol 1e-5 of its run
  alone.
- (f) ``coord_check_batched`` under int8 u-µP against the reference's
  (RTOL 5e-3 / ATOL 1e-6, threefry flag set as in
  ``tests/test_torch_coord_check.py``), each lr's slope flat.
- (g) A batched amp step calls B5 and B6 + B7 once a layer whatever N.
  On the card (marked ``gpu``): (b) and (g) with the real kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import coord_check as jcoord  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.core.init import init_params as jinit_params  # noqa: E402
from repro.core.parametrization import resolve as jresolve  # noqa: E402
from repro.data.pipeline import make_pipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.quant import QuantPolicy as JPolicy  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import coord_check as tcoord  # noqa: E402
from repro_torch.core import hp as thp  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.hpspace import mup_space  # noqa: E402
from repro_torch.core.init import init_candidates  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.core.parametrization import resolve as tresolve  # noqa: E402
from repro_torch.kernels import cross_entropy as ce  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim.optimizer import Optimizer  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.quant import core as qcore  # noqa: E402

MODES = ("none", "bf16", "int8")
AMPS = ("bf16", "int8")
N = 3
SCALES = (0.125, 0.25, 0.0625)   # a scale per candidate (powers of two)
F32_TOL = (2e-5, 2e-4, 1e-3)     # forward atol, gradient atol / rtol
ROUNDED_MAX = {"bf16": {"o": 2e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2},
               "int8": dict.fromkeys(("o", "dq", "dk", "dv"), 5e-2)}
ROUNDED_MEAN = 3e-5
LOSS_RTOL = 1e-4            # tests/test_torch_amp_int8.py's one int8 loss_fn
SWEEP_RTOL = 2e-3           # the reference's batched-vs-serial tolerance
ALONE_RTOL = 1e-5           # the reference's "does not poison" tolerance
CC_RTOL, CC_ATOL = 5e-3, 1e-6   # tests/test_torch_coord_check.py's
COORD_SLOPE_MAX = 0.1
KW = dict(steps=3, batch_size=4, seq_len=128)
CANDIDATES = [dict(lr=5e-3), dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
              dict(lr=2e-2, sigma=2.0, alpha_attn=2.0, alpha_embed=0.5)]
# B, S, H, K, d, window, softcap: one 128-key tile a row
FOLD_CASES = {"gqa": (1, 128, 4, 2, 32, 0, 0.0),
              "window": (1, 128, 4, 2, 32, 48, 0.0),
              "softcap": (1, 128, 4, 2, 32, 0, 20.0)}
# q, k, v each batched (0) or shared by the candidates (None)
IN_DIMS = {"all batched": (0, 0, 0), "k, v shared": (0, None, None),
           "q shared": (None, 0, 0)}


@pytest.fixture(scope="module", autouse=True)
def _threefry_as_written_and_one_thread():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(n)


def _policy(mode):
    return None if mode == "none" else QuantPolicy(mode)


def _inputs(B, S, H, K, d, seed=0):
    """q, k, v and a cotangent of order 1 for N candidates, float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N,) + s).astype(np.float32)
            for s in ((B, S, H, d), (B, S, K, d), (B, S, K, d), (B, S, H, d))]


# ---------------------------------------------------------------------------
# (a) the folded plain flash versions against jax.vmap of the reference kernel
# ---------------------------------------------------------------------------

def _reference_vmapped(arrays, window, softcap, mode):
    """(o, dq, dk, dv) of jax.vmap over the candidates of the reference's
    interpret-mode ops.attention and its jax.vjp, a scale per candidate."""
    policy = None if mode == "none" else JPolicy(mode)

    def one(q, k, v, scale, do):
        def f(q, k, v):
            return jops.attention(q, k, v, scale=scale, causal=True, window=window,
                                  softcap=softcap, block_q=128, block_k=128,
                                  impl="interpret", policy=policy)
        o, vjp = jax.vjp(f, q, k, v)
        return (o, *vjp(do))

    q, k, v, do = (jnp.asarray(a) for a in arrays)
    out = jax.vmap(one)(q, k, v, jnp.asarray(SCALES, jnp.float32), do)
    return [np.asarray(x) for x in out]


def _port_folded(arrays, window, softcap, mode, attend=ops.attention_plain_flash,
                 in_dims=(0, 0, 0)):
    """(o, dq, dk, dv) of ``attend`` under torch.func.vmap over the
    candidates (an operand of in_dims None is candidate 0's, shared), a
    scale per candidate, gradients by one backward outside the vmap."""
    q, k, v, do = (torch.from_numpy(a.copy()) for a in arrays)
    q, k, v = (t if d is not None else t[0] for t, d in zip((q, k, v), in_dims))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    fn = torch.func.vmap(
        lambda a, b, c, s: attend(a, b, c, scale=s, causal=True, window=window,
                                  softcap=softcap, policy=_policy(mode)),
        in_dims=(*in_dims, 0))
    o = fn(q, k, v, torch.tensor(SCALES))
    return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_folded_plain_flash_matches_vmapped_reference_kernel(case, mode):
    B, S, H, K, d, window, softcap = FOLD_CASES[case]
    arrays = _inputs(B, S, H, K, d)
    got = [t.numpy() for t in _port_folded(arrays, window, softcap, mode)]
    want = _reference_vmapped(arrays, window, softcap, mode)
    names = ("o", "dq", "dk", "dv")
    if mode == "none":
        f_atol, g_atol, g_rtol = F32_TOL
        np.testing.assert_allclose(got[0], want[0], atol=f_atol, rtol=0, err_msg="o")
        for name, g, w in zip(names[1:], got[1:], want[1:]):
            np.testing.assert_allclose(g, w, atol=g_atol, rtol=g_rtol, err_msg=name)
        return
    for name, g, w in zip(names, got, want):
        diff = np.abs(g - w)
        assert diff.max() <= ROUNDED_MAX[mode][name] and diff.mean() <= ROUNDED_MEAN, \
            (case, mode, name, float(diff.max()), float(diff.mean()))


@pytest.mark.parametrize("mode", MODES)
def test_model_attention_under_vmap_equals_separate_calls(mode):
    """The path a CPU sweep runs (ops.attention's plain attention, its
    policy matmuls through _QuantMatmul's vmap rule): each candidate's
    output and gradients equal a call on that candidate alone, bit for
    bit."""
    B, S, H, K, d, window, softcap = FOLD_CASES["softcap"]
    arrays = _inputs(B, S, H, K, d, seed=3)
    got = _port_folded(arrays, window, softcap, mode, attend=ops.attention)
    for i in range(N):
        q, k, v, do = (torch.from_numpy(a[i].copy()) for a in arrays)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        o = ops.attention(q, k, v, scale=SCALES[i], causal=True, window=window,
                          softcap=softcap, policy=_policy(mode))
        want = [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            assert torch.equal(g[i], w), (mode, i, name)


# ---------------------------------------------------------------------------
# (b) one call of the wrappers for N candidates, for every in_dims
# ---------------------------------------------------------------------------

@pytest.fixture
def flash_branch(monkeypatch):
    """ops' kernel branch on the CPU: resolve_impl says "kernel" and the
    CUDA wrappers are stood in for by their plain versions, B5's and B6 +
    B7's recording the q shapes they are handed."""
    seen = {"fwd": [], "bwd": []}

    def fwd(q, k, v, **kw):
        seen["fwd"].append(tuple(q.shape))
        return ref.flash_fwd_ref(q, k, v, **kw)

    def bwd(q, k, v, do, lse, delta, **kw):
        seen["bwd"].append(tuple(q.shape))
        return ref.flash_bwd_ref(q, k, v, do, lse, delta, **kw)

    monkeypatch.setattr(ops, "resolve_impl", lambda impl, x: "kernel")
    monkeypatch.setattr(fa, "flash_fwd", fwd)
    monkeypatch.setattr(fa, "flash_bwd", bwd)
    monkeypatch.setattr(rn, "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(rn, "rmsnorm_bwd", ref.rmsnorm_bwd_ref)
    monkeypatch.setattr(ce, "ce_fwd", ref.softmax_cross_entropy_ref)
    monkeypatch.setattr(ce, "ce_bwd", ref.softmax_cross_entropy_bwd_ref)
    return seen


def _separate(arrays, i, window, softcap, mode):
    """(o, dq, dk, dv) of ops.attention on candidate i alone."""
    q, k, v, do = (torch.from_numpy(a[i].copy()) for a in arrays)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = ops.attention(q, k, v, scale=SCALES[i], causal=True, window=window,
                      softcap=softcap, policy=_policy(mode))
    return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))


@pytest.mark.parametrize("dims", sorted(IN_DIMS))
@pytest.mark.parametrize("mode", MODES)
def test_flash_vmap_rule_makes_one_call(flash_branch, mode, dims):
    """One B5 call and one B6 + B7 call for N candidates, the candidate axis
    folded into B; candidate i's slice equals a call on candidate i alone
    bit for bit, and a shared operand's gradient is the sum of the
    candidates' own."""
    B, S, H, K, d, window, softcap = FOLD_CASES["window"]
    in_dims = IN_DIMS[dims]
    arrays = _inputs(B, S, H, K, d, seed=1)
    # a shared operand is candidate 0's for every candidate
    arrays = [a if d is not None else np.broadcast_to(a[:1], a.shape)
              for a, d in zip(arrays, in_dims + (0,))]
    got = _port_folded(arrays, window, softcap, mode, attend=ops.attention, in_dims=in_dims)
    assert flash_branch["fwd"] == [(N * B, S, H, d)]
    assert flash_branch["bwd"] == [(N * B, S, H, d)]
    want = [_separate(arrays, i, window, softcap, mode) for i in range(N)]
    assert flash_branch["fwd"][1:] == [(B, S, H, d)] * N
    for j, name in enumerate(("o", "dq", "dk", "dv")):
        if j == 0 or in_dims[j - 1] is not None:
            for i in range(N):
                assert torch.equal(got[j][i], want[i][j]), (mode, dims, name, i)
        else:
            assert torch.equal(got[j], torch.stack([w[j] for w in want]).sum(0)), \
                (mode, dims, name)


# x (rows, k), w (k, n), each batched over N or shared
QMM_DIMS = {"x and w batched": (0, 0), "w shared": (0, None), "x shared": (None, 0)}


@pytest.mark.parametrize("dims", sorted(QMM_DIMS))
@pytest.mark.parametrize("mode", MODES)
def test_quant_matmul_vmap_rule(monkeypatch, mode, dims):
    """One kernel_dot call forward and two backward for N candidates, with
    the candidate axis leading (scales per candidate); each slice equals a
    call on its candidate alone bit for bit; a shared operand's gradient is
    the sum of the per-candidate gradients, each quantized on its own."""
    calls = []
    real = qcore.kernel_dot

    def recording(a, b, policy=None):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, policy)

    xd, wd = QMM_DIMS[dims]
    rng = np.random.default_rng(2)
    x = torch.from_numpy((3 * rng.standard_normal((N, 40, 24))).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, 24, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((N, 40, 16)).astype(np.float32))
    x = x if xd is not None else x[0]
    w = w if wd is not None else w[0]
    lx, lw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    policy = _policy(mode)
    monkeypatch.setattr(qcore, "kernel_dot", recording)
    y = torch.func.vmap(lambda a, b: qcore.quant_matmul(a, b, policy), in_dims=(xd, wd))(lx, lw)
    dx, dw = torch.autograd.grad(y, (lx, lw), g)
    assert calls == [((N, 40, 24), (N, 24, 16)), ((N, 40, 16), (N, 16, 24)),
                     ((N, 24, 40), (N, 40, 16))]
    want = []
    for i in range(N):
        xi = (x[i] if xd is not None else x).clone().requires_grad_(True)
        wi = (w[i] if wd is not None else w).clone().requires_grad_(True)
        yi = qcore.quant_matmul(xi, wi, policy)
        want.append((yi.detach(), *torch.autograd.grad(yi, (xi, wi), g[i])))
    for i in range(N):
        assert torch.equal(y[i], want[i][0]), (mode, dims, i)
    for got, d, j in ((dx, xd, 1), (dw, wd, 2)):
        if d is not None:
            assert all(torch.equal(got[i], want[i][j]) for i in range(N)), (mode, dims, j)
        else:
            assert torch.equal(got, torch.stack([wt[j] for wt in want]).sum(0)), (mode, dims, j)
    if mode == "int8" and wd is None:
        # the control: w's gradient from x's rows folded over the candidates
        # takes g's column scales over all N candidates' rows at once
        folded = real(x.reshape(-1, 24).t(), g.reshape(-1, 16), policy)
        assert not torch.allclose(folded, dw, rtol=1e-4, atol=0)


def test_candidate_fold_limits_name_the_count():
    """A fold past the grid's 65,535 batch rows or int32 indexing raises,
    naming the candidate count; the sweep's own fold is far inside."""
    fa.check_candidates(16, (8, 64, 4, 64), (8, 64, 4, 64))
    with pytest.raises(ValueError, match="over 8200 candidates"):
        fa.check_candidates(8200, (8, 64, 4, 64), (8, 64, 4, 64))
    with pytest.raises(ValueError, match="over 64 candidates"):
        fa.check_candidates(64, (4, 8192, 16, 256), (4, 8192, 8, 256))


# ---------------------------------------------------------------------------
# (c)-(e) the amp sweep against the reference and against itself
# ---------------------------------------------------------------------------

def _candidates():
    space = mup_space()
    return [space.hparams(**c) for c in CANDIDATES]


def _reference_init(jcfg, cands):
    """The reference engine's init: init_params at candidate_rngs(0, n)[i]
    with candidate i's sigma, stacked, carried across by name."""
    model = jbuild(jcfg.replace(dtype="float32"))
    stacked = jax.vmap(lambda r, s: jinit_params(r, model.meta, model.p13n, sigma=s))(
        jtuning.candidate_rngs(0, len(cands)),
        jnp.asarray([h.sigma for h in cands], jnp.float32))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                        lambda x: isinstance(x, np.ndarray))
    return params_from_numpy(flat, device="cpu")


@pytest.mark.parametrize("amp", AMPS)
def test_amp_sweep_matches_reference_and_serial(amp):
    cands = _candidates()
    cfg = tsmoke("mup-gpt").replace(amp=amp)
    init = _reference_init(jsmoke("mup-gpt"), cands)
    got = ttuning.train_proxy_batched(cfg, cands, device="cpu",
                                      init_fn=lambda gens, hp: init, **KW)
    want = jtuning.train_proxy_batched(jsmoke("mup-gpt").replace(amp=amp), cands, **KW)
    assert got.active.all() and got.steps_run == KW["steps"]
    np.testing.assert_allclose(got.curves[0], want.curves[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.curves, want.curves, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(got.losses, want.losses, rtol=SWEEP_RTOL)
    assert got.best_index == want.best_index
    ser = ttuning.train_proxy_serial(cfg, cands, device="cpu",
                                     init_fn=lambda gens, hp: init, **KW)
    np.testing.assert_allclose(got.curves, ser.curves, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(got.losses, ser.losses, rtol=SWEEP_RTOL)
    # amp changes the numbers: the f32 sweep on the same init differs
    f32 = ttuning.train_proxy_batched(tsmoke("mup-gpt"), cands, device="cpu",
                                      init_fn=lambda gens, hp: init, **KW)
    assert not np.allclose(f32.curves[1:], got.curves[1:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("amp", AMPS)
def test_amp_random_search_and_train_proxy_run(amp):
    """random_search batched and serial, and the legacy train_proxy, under
    the policy: finite scores, the batched search's scores equal to its
    engine's on the same samples."""
    cfg = tsmoke("mup-gpt").replace(amp=amp)
    kw = dict(steps=2, batch_size=2, seq_len=64, seed=0, device="cpu")
    best, trials = ttuning.random_search(cfg, n_samples=3, **kw)
    assert len(trials) == 3 and all(np.isfinite(s) for _, s in trials)
    res = ttuning.train_proxy_batched(cfg, [h for h, _ in trials], **kw)
    np.testing.assert_array_equal(res.losses, [s for _, s in trials])
    assert best == res.best
    _, serial = ttuning.random_search(cfg, n_samples=2, batched=False, **kw)
    assert all(np.isfinite(s) for _, s in serial)
    assert np.isfinite(ttuning.train_proxy(cfg, trials[0][0], **kw))


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_int8_divergence_is_frozen_and_does_not_poison():
    """Under int8 a candidate at lr 1e25 is pruned, its params and Adam
    moments keep their bits, and its neighbour's curve is the one it has
    alone: no quantization scale is shared across candidates."""
    space = mup_space()
    cfg = tsmoke("mup-gpt").replace(amp="int8")
    good = space.hparams(lr=5e-3)
    kw = dict(KW, steps=6, seq_len=64)
    res = ttuning.train_proxy_batched(cfg, [good, space.hparams(lr=1e25)], device="cpu", **kw)
    assert res.active[0] and not res.active[1] and res.best_index == 0
    diverged = int(np.argmax(np.isinf(res.curves[:, 1])))
    assert np.isinf(res.curves[diverged:, 1]).all() and diverged < kw["steps"] - 1
    alone = ttuning.train_proxy_batched(cfg, [good], device="cpu", **kw)
    np.testing.assert_allclose(res.curves[:, 0], alone.curves[:, 0], rtol=ALONE_RTOL)

    # the batched step by hand: once pruned, nothing of the candidate moves
    model = tbuild(cfg.replace(dtype="float32"), device="cpu")
    hp = thp.stack_hparams([good, space.hparams(lr=1e25)], device="cpu")
    opt = Optimizer.create("adamw", 0.0, model.p13n, model.meta, schedule=constant())
    params = init_candidates(ttuning.candidate_generators(0, 2, device="cpu"), model.meta,
                             model.p13n, [1.0, 1.0])
    state = opt.init(params)
    active = torch.ones(2, dtype=torch.bool)
    step = ttuning.make_batched_step(lambda p, b, h: model.loss_fn(p, b, hp=h), opt)
    frozen = 0
    for batch in ttuning._proxy_batches(cfg, 5, 4, 64, 0, "cpu"):
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


@pytest.mark.parametrize("amp", AMPS)
def test_experiment_algorithm1_under_amp(amp):
    """Algorithm 1 through Experiment with the policy set: the proxy keeps
    it; coord_check over two lrs (each lr's records equal its one-lr
    check's, at the batched check's tolerance), tune (its scores those of
    the engine on the same draws) and train run under it, finite."""
    from repro_torch.api import Experiment

    exp = Experiment.from_config("mup-gpt", device="cpu", amp=amp)
    proxy = exp.proxy(0.5)
    assert proxy.cfg.amp == amp
    kw = dict(widths=(1.0, 2.0), steps=2, batch_size=2, seq_len=32)
    cc = proxy.coord_check(lrs=(1e-2, 2e-2), **kw)
    for i, lr in enumerate((1e-2, 2e-2)):
        one = proxy.coord_check(lr=lr, **kw)
        for w, recs in one.records.items():
            for t, step in enumerate(recs):
                for k, x in step.items():
                    np.testing.assert_allclose(cc.records[w][t][k][i], x, rtol=CC_RTOL,
                                               atol=CC_ATOL, err_msg=f"{lr} {w} {t} {k}")
    res = proxy.tune(n_samples=3, steps=2, batch_size=2, seq_len=32)
    same = ttuning.train_proxy_batched(proxy.cfg, proxy.space.sample_n(3, seed=0), steps=2,
                                       batch_size=2, seq_len=32, device="cpu")
    np.testing.assert_array_equal(res.losses, same.losses)
    assert np.isfinite(res.losses).all() and proxy.hps == res.best
    out = proxy.transfer(exp).train(steps=2, batch_size=2, seq_len=32, log_every=0)
    assert np.isfinite(out["losses"]).all()


# ---------------------------------------------------------------------------
# (f) the batched coord check under int8 u-µP
# ---------------------------------------------------------------------------

CC_WIDTHS, CC_LRS, CC_STEPS = (1.0, 2.0, 4.0), (1e-2, 2e-2), 3


def _cc_factories():
    """The reference's and the port's make_model on u-µP mup-gpt under int8
    amp, the port on the reference's init (tests/test_torch_coord_check.py's
    factories)."""
    jbase = jsmoke("mup-gpt").replace(dtype="float32", n_layers=2, parametrization="umup",
                                      amp="int8", zero_init_readout=False,
                                      zero_init_query=False)
    tbase = tsmoke("mup-gpt").replace(dtype="float32", n_layers=2, parametrization="umup",
                                      amp="int8", zero_init_query=False)

    def jmake(i):
        model = jbuild(jbase.scaled(CC_WIDTHS[i]))
        return (model.init(jax.random.PRNGKey(0)), model.meta,
                lambda p, b: model.loss_fn(p, b, collect_acts=True))

    def tmake(i):
        jparams = jbuild(jbase.scaled(CC_WIDTHS[i])).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        model = tbuild(tbase.scaled(CC_WIDTHS[i]), device="cpu")
        return params, model.meta, lambda p, b: model.loss_fn(p, b, collect_acts=True)

    pipe = make_pipeline(256, 32, 8, seed=0)
    raw = [pipe.batch(t) for t in range(CC_STEPS)]
    return (jmake, [{k: jnp.asarray(v) for k, v in b.items()} for b in raw],
            tmake, [{k: torch.from_numpy(v) for k, v in b.items()} for b in raw])


def test_int8_umup_coord_check_batched_matches_reference():
    jmake, jb, tmake, tb = _cc_factories()
    widths = list(range(len(CC_WIDTHS)))
    got = tcoord.coord_check_batched(tmake, widths, tb, tresolve("umup"), lrs=CC_LRS)
    want = jcoord.coord_check_batched(jmake, widths, jb, jresolve("umup"), lrs=CC_LRS)
    assert sorted(got.records) == sorted(want.records)
    for w, steps in want.records.items():
        for t, (g, r) in enumerate(zip(got.records[w], steps)):
            assert sorted(g) == sorted(r), (w, t)
            for k in r:
                np.testing.assert_allclose(g[k], np.asarray(r[k]), rtol=CC_RTOL, atol=CC_ATOL,
                                           err_msg=f"w={w} t={t} {k}")
    got.records = {64 * int(CC_WIDTHS[i]): v for i, v in got.records.items()}
    for i in range(len(CC_LRS)):
        assert got.growth("logits.delta", candidate=i) < COORD_SLOPE_MAX, CC_LRS[i]
        assert all(np.isfinite(step["logits"]).all() for recs in got.records.values()
                   for step in recs)


# ---------------------------------------------------------------------------
# (g) one call of B5 and of B6 + B7 a layer, whatever N
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", AMPS)
def test_batched_amp_step_calls_flash_once_a_layer(flash_branch, amp):
    cfg = tsmoke("mup-gpt").replace(amp=amp)
    steps, B, S = 2, 2, 16
    for n in (1, N):
        flash_branch["fwd"].clear()
        flash_branch["bwd"].clear()
        ttuning.train_proxy_batched(cfg, _candidates()[:n], device="cpu", steps=steps,
                                    batch_size=B, seq_len=S)
        want = [(n * B, S, cfg.n_heads, cfg.d_head)] * (cfg.n_layers * steps)
        assert flash_branch["fwd"] == want and flash_branch["bwd"] == want, (amp, n)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")


FLASH_COUNTS = {"none": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                "bf16": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                "int8": ("flash_fwd_int8", "flash_bwd_dq_int8", "flash_bwd_dkv_int8",
                         "flash_fwd_quant_int8", "flash_bwd_quant_int8")}


@pytest.mark.gpu
@pytest.mark.parametrize("dims", sorted(IN_DIMS))
@pytest.mark.parametrize("mode", MODES)
def test_flash_vmap_rule_one_launch_on_card(mode, dims):
    """One launch of each kernel of the mode for N candidates; candidate
    i's slice equals a launch on candidate i alone bit for bit."""
    _card()
    B, S, H, K, d = 2, 200, 4, 2, 64
    in_dims = IN_DIMS[dims]
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ((N, B, S, H, d), (N, B, S, K, d), (N, B, S, K, d), (N, B, S, H, d))
    q, k, v, do = (torch.randn(s, device="cuda", generator=gen) for s in shapes)
    q, k, v = (t if dd is not None else t[0] for t, dd in zip((q, k, v), in_dims))
    lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
    kw = dict(causal=True, window=48, softcap=20.0, policy=_policy(mode))
    ops.reset_launch_counts()
    o = torch.func.vmap(lambda a, b, c, s: ops.attention(a, b, c, scale=s, **kw),
                        in_dims=(*in_dims, 0))(lq, lk, lv, torch.tensor(SCALES, device="cuda"))
    grads = torch.autograd.grad(o, (lq, lk, lv), do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {n: c for n, c in counts.items() if c} == dict.fromkeys(FLASH_COUNTS[mode], 1)
    for i in range(N):
        ai, bi, ci = (t[i] if dd is not None else t for t, dd in zip((q, k, v), in_dims))
        ai, bi, ci = (t.clone().requires_grad_(True) for t in (ai, bi, ci))
        oi = ops.attention(ai, bi, ci, scale=SCALES[i], **kw)
        gi = torch.autograd.grad(oi, (ai, bi, ci), do[i])
        assert torch.equal(o[i], oi), (mode, dims, i)
        for j, dd in enumerate(in_dims):
            if dd is not None:
                assert torch.equal(grads[j][i], gi[j]), (mode, dims, i, j)


@pytest.mark.gpu
@pytest.mark.parametrize("amp", AMPS)
def test_batched_amp_step_launches_on_card(amp):
    _card()
    cfg = tsmoke("mup-gpt").replace(amp=amp)
    steps = 3
    for n in (1, N):
        ops.reset_launch_counts()
        ttuning.train_proxy_batched(cfg, _candidates()[:n], device="cuda", steps=steps,
                                    batch_size=4, seq_len=128)
        counts = ops.launch_counts()
        per = cfg.n_layers * steps
        assert all(counts[name] == per for name in FLASH_COUNTS[amp]), (amp, n, counts)
        assert counts["rmsnorm_grouped"] == (2 * cfg.n_layers + 1) * steps
        assert counts["ce_fwd"] == counts["ce_bwd"] == steps
