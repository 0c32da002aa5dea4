"""The RG-LRU block and the non-repeating tail in the port against the
reference: recurrentgemma-9b's configs, parameter metas and counts, the
init, the RG-LRU pieces (``_causal_conv``, ``_gates``, ``rglru_scan``,
``rglru_step``, ``rglru_block`` in train, prefill and decode, and its
gradients), the model's logits, loss and every gradient (tail included) in
f32, bf16 and int8 at the smoke's width and at ``.scaled(2)`` (and in f32
under SP), decode
against the full forward and the reference's decode across the window's
ring wrap, the µP-health statistics of the tail, the train CLI's first
loss on the reference's weights, and the batched sweep and coord check on
recurrentgemma's smoke family against the reference and the serial runs.

The RG-LRU mixer reaches no Pallas kernel in the reference, so its CPU path
is the reference itself; under amp the local layer's attention takes the
flash kernels' plain versions on both sides.  Weights come from the
reference's init and move over by ``convert.params_from_numpy``; inputs
are drawn with numpy from fixed seeds.  Tolerances: the f32 tiers (values
atol 2e-5 / rtol 1e-5 a piece, 1e-4 for logits, gradients atol 2e-4 /
rtol 1e-3), the loss within 1e-5 relative, decode logits within 1e-4 of
max |logit| (the reference's bar in tests/test_smoke_archs.py), the amp
bars of tests/test_torch_gemma2.py, the sweep at the reference's 2e-3.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import coord_check as jcoord  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.core.init import init_params as jinit_params  # noqa: E402
from repro.core.meta import flatten_meta as j_flatten_meta  # noqa: E402
from repro.core.parametrization import resolve as jresolve  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.layers import activation as j_activation  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim.optimizer import Optimizer as JOptimizer  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import coord_check as tcoord  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.hpspace import mup_space  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.core.parametrization import resolve as tresolve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_step  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.obs import telemetry as ttelemetry  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim.optimizer import Optimizer as TOptimizer  # noqa: E402

ARCH = "recurrentgemma-9b"
F32 = dict(atol=2e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
DECODE_BAR = 1e-4               # of max |logit|, tests/test_smoke_archs.py's
SWEEP_RTOL = 2e-3               # the reference's batched-vs-serial tolerance
CC_RTOL, CC_ATOL = 5e-3, 1e-6   # tests/test_torch_coord_check.py's
# (loss tolerance, gradient tolerance, largest error as a share of the
# tensor's largest entry): tests/test_torch_gemma2.py's TRAIN_BARS
TRAIN_BARS = {
    "f32": (dict(atol=2e-5, rtol=1e-6), GRAD_TOL, None),
    "bf16": (dict(rtol=1e-3), dict(atol=5e-2, rtol=5e-2), 0.02),
    "int8": (dict(rtol=1e-4), dict(atol=5e-2, rtol=5e-2), 0.02),
}
# a random query projection: µP's zero-init query makes attention uniform
OVER = dict(dtype="float32", zero_init_query=False)


@pytest.fixture(scope="module", autouse=True)
def _threefry_as_written_and_one_thread():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(n)


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


_PAIRS = {}


def _pair(width=1.0, amp="", p13n="mup"):
    """(reference model, its params, port model, the same params) of the
    smoke at ``width`` times its widths (its own µP base)."""
    key = (width, amp, p13n)
    if key not in _PAIRS:
        over = dict(OVER, amp=amp, parametrization=p13n)
        jcfg, tcfg = j_smoke(ARCH, **over), t_smoke(ARCH, **over)
        if width != 1.0:
            jcfg, tcfg = jcfg.scaled(width), tcfg.scaled(width)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _PAIRS[key] = (jm, jp, tbuild(tcfg, device="cpu"), _to_torch(jp))
    return _PAIRS[key]


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **tol)


def _batch(V, B=2, S=24, seed=0):
    """Tokens and labels with masked (-100) positions; S = 24 runs past the
    smoke's window of 8."""
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


# ---------------------------------------------------------------------------
# configs, metas, counts and the init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_the_reference(size):
    """Every field the port keeps equals the reference's, lru_width and the
    tail among them; lru_width scales with the width; param_count is the
    reference's formula (8.524 B at full size: it leaves out w_a and w_x)."""
    t = (t_config if size == "full" else t_smoke)(ARCH)
    j = (j_config if size == "full" else j_smoke)(ARCH)
    kept = {f.name for f in dataclasses.fields(t)}
    assert {"lru_width", "conv_width", "tail", "window_size"} <= kept
    for name in kept:
        assert getattr(t, name) == getattr(j, name), name
    assert t.tail == ("recurrent", "recurrent") and t.n_groups == j.n_groups
    assert t.param_count() == j.param_count()
    for f in (0.25, 2.0):
        assert t.scaled(f).lru_width == j.scaled(f).lru_width
        assert t.scaled(f).param_count() == j.scaled(f).param_count()
    if size == "full":
        assert t.n_groups == 12 and t.param_count() == 8_524_103_680
        assert t.scaled(0.25).lru_width == 1024


def _meta_fields(m, p13n):
    ish = m.infshape
    rule = m.rule(p13n)
    return dict(
        dims=[(d.dim, d.base_dim, d.is_width) for d in ish.dims],
        fan_in=tuple(ish.fan_in_axes), fan_out=tuple(ish.fan_out_axes),
        role=str(m.resolved_role().name), init=m.init, owns=m.owns_scale,
        lr_axis=m.lr_axis, init_std=rule.init_std, mult=rule.multiplier,
        adam=rule.adam_lr_mult, sgd=rule.sgd_lr_mult)


@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_metas_equal_the_reference(size, width):
    """Every tensor's name (the tail's ``tail.<i>_<kind>.*`` too), shape,
    base shape, width axes, fans, role, init kind, init std, forward
    multiplier and LR multipliers equal the reference's, under µP and SP;
    at full size the 38 layers' metas hold 9,396,408,320 parameters."""
    get_t, get_j = (t_config, j_config) if size == "full" else (t_smoke, j_smoke)
    tcfg, jcfg = get_t(ARCH, n_layers=5), get_j(ARCH, n_layers=5)
    if width != 1.0:
        tcfg, jcfg = tcfg.scaled(width), jcfg.scaled(width)
    tmeta = tbuild(tcfg, device="cpu").flat_meta
    jmeta = j_flatten_meta(jbuild(jcfg).meta)
    assert sorted(tmeta) == sorted(jmeta)
    assert "tail.1_recurrent.mixer.lam" in tmeta and "groups.2_local.attn.wq" in tmeta
    for p13n in ("mup", "sp"):
        for name in jmeta:
            assert (_meta_fields(tmeta[name], tresolve(p13n))
                    == _meta_fields(jmeta[name], jresolve(p13n))), (p13n, name)
    if size == "full" and width == 1.0:
        full = tbuild(t_config(ARCH), device="cpu").flat_meta
        assert sum(math.prod(m.infshape.shape) for m in full.values()) == 9_396_408_320


def test_init_statistics():
    """The port's own init of recurrentgemma's smoke at 8x its width (d_model
    512): each normal tensor at its rule's init_std (within 5%, or four
    times the sample std's spread), lam normal at scale 1, the biases and
    norm gains zero; conv_w and lam applied raw (owns_scale False)."""
    model = tbuild(t_smoke(ARCH, dtype="float32").scaled(8), device="cpu")
    params = model.init(0)
    for name, m in model.flat_meta.items():
        t = params[name]
        if m.init == "zeros":
            assert not t.any(), name
        else:
            std = t.std().item()
            rel = max(0.05, 4 / math.sqrt(2 * t.numel()))
            assert std == pytest.approx(m.rule(model.p13n).init_std, rel=rel), name
    for where in ("groups.0_recurrent", "tail.1_recurrent"):
        lam = model.flat_meta[f"{where}.mixer.lam"]
        assert (lam.init, lam.init_scale, lam.owns_scale) == ("normal", 1.0, False)
        assert not model.flat_meta[f"{where}.mixer.conv_w"].owns_scale
        for b in ("conv_b", "b_a", "b_x"):
            assert model.flat_meta[f"{where}.mixer.{b}"].init == "zeros"


# ---------------------------------------------------------------------------
# the RG-LRU pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_causal_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(1)
    u, w, b = _rand(rng, 2, 9, 20), _rand(rng, 4, 20, scale=0.5), _rand(rng, 20)
    st = _rand(rng, 2, 3, 20) if with_state else None
    y, s = trglru._causal_conv(*map(torch.from_numpy, (u, w, b)),
                               None if st is None else torch.from_numpy(st))
    jy, js = jrglru._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    _close(y, jy, **F32)
    _close(s, js, **F32)


def _mixer(width=1.0, seed=5):
    """The tail's first block's mixer params (reference and port), its metas,
    with lam and the biases moved off their init (lam up to 25, where a
    softplus with a linear cutoff would leave the reference's form)."""
    jm, jp, tm, tp = _pair(width)
    rng = np.random.default_rng(seed)
    jparams = dict(jp["tail"]["0_recurrent"]["mixer"])
    for k in ("lam", "b_a", "b_x", "conv_b"):
        jparams[k] = jnp.asarray(_rand(rng, *jparams[k].shape, scale=2.0))
    jparams["lam"] = jparams["lam"].at[:4].set(jnp.asarray([-6.0, 0.0, 21.0, 25.0]))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return (jm, jparams, jm.meta["tail"]["0_recurrent"]["mixer"],
            tm, tparams, tm.tail_meta["0_recurrent"]["mixer"])


def test_gates_match_the_reference():
    """a and the gated input in f32, the decay from log a as the reference
    rounds it: r and i in the activation dtype, sqrt(max(1 - exp(2 log a),
    1e-12))."""
    jm, jparams, jmeta, tm, tparams, tmeta = _mixer()
    u = _rand(np.random.default_rng(6), 2, 11, jm.cfg.lru_width)
    a, b = trglru._gates(tparams, tmeta, torch.from_numpy(u), tm.p13n)
    ja, jb = jrglru._gates(jparams, jmeta, jnp.asarray(u), jm.p13n)
    assert a.dtype == b.dtype == torch.float32
    _close(a, ja, **F32)
    _close(b, jb, **F32)


def _recurrence_f64(a, b, h0):
    """h_t = a_t h_{t-1} + b_t one position at a time in float64 numpy."""
    h = np.zeros(a[:, 0].shape) if h0 is None else h0.astype(np.float64)
    out = np.empty(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("given_h0", [False, True], ids=["h0_none", "h0_given"])
def test_rglru_scan_matches_the_reference(given_h0):
    """S 37 (not a power of two): the doubling scan against the reference's
    associative_scan (y and the last h at the f32 tiers), and the port's
    float64 scan against a float64 recurrence on the same gates (1e-12)."""
    jm, jparams, jmeta, tm, tparams, tmeta = _mixer()
    rng = np.random.default_rng(7)
    u = _rand(rng, 2, 37, jm.cfg.lru_width)
    h0 = _rand(rng, 2, jm.cfg.lru_width) if given_h0 else None
    y, h = trglru.rglru_scan(tparams, tmeta, torch.from_numpy(u), tm.p13n,
                             h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = jrglru.rglru_scan(jparams, jmeta, jnp.asarray(u), jm.p13n,
                               h0=None if h0 is None else jnp.asarray(h0))
    assert h.dtype == torch.float32
    _close(y, jy, **F32)
    _close(h, jh, **F32)
    p64 = {k: v.double() for k, v in tparams.items()}
    u64 = torch.from_numpy(u).double()
    y64, _ = trglru.rglru_scan(p64, tmeta, u64, tm.p13n,
                               h0=None if h0 is None else torch.from_numpy(h0).double())
    a, b = (t.numpy() for t in trglru._gates(p64, tmeta, u64, tm.p13n))
    exact = _recurrence_f64(a, b, h0)
    assert np.abs(y64.numpy() - exact).max() <= 1e-12 * np.abs(exact).max()


def test_rglru_step_matches_the_reference():
    jm, jparams, jmeta, tm, tparams, tmeta = _mixer()
    rng = np.random.default_rng(8)
    u, h = _rand(rng, 3, 1, jm.cfg.lru_width), _rand(rng, 3, jm.cfg.lru_width)
    y, hn = trglru.rglru_step(tparams, tmeta, *map(torch.from_numpy, (u, h)), tm.p13n)
    jy, jhn = jrglru.rglru_step(jparams, jmeta, jnp.asarray(u), jnp.asarray(h), jm.p13n)
    _close(y, jy, **F32)
    _close(hn, jhn, **F32)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_matches_the_reference(mode):
    """rglru_block's output and its new cache (h f32, conv inputs) in each
    mode; decode from a random state."""
    jm, jparams, jmeta, tm, tparams, tmeta = _mixer()
    rng = np.random.default_rng(9)
    S = 1 if mode == "decode" else 13
    x = _rand(rng, 2, S, jm.cfg.d_model)
    cache = None
    if mode == "decode":
        cache = {"h": _rand(rng, 2, jm.cfg.lru_width),
                 "conv": _rand(rng, 2, jm.cfg.conv_width - 1, jm.cfg.lru_width)}
    out, c = trglru.rglru_block(
        tm.cfg, tparams, tmeta, torch.from_numpy(x), tm.p13n,
        None if cache is None else {k: torch.from_numpy(v) for k, v in cache.items()},
        mode=mode)
    jout, jc = jrglru.rglru_block(
        jm.cfg, jparams, jmeta, jnp.asarray(x), jm.p13n, j_activation("gelu"),
        None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()},
        mode=mode)
    _close(out, jout, **LOGIT_TOL)
    if mode == "train":
        assert c is None and jc is None
        return
    assert sorted(c) == sorted(jc) == ["conv", "h"] and c["h"].dtype == torch.float32
    for k in c:
        _close(c[k], jc[k], **F32)


def test_rglru_block_gradients_match_the_reference():
    """The gradients of sum(out * w) with respect to the block's input and
    every mixer weight against jax.grad, at .scaled(2) (the hidden
    matrices' multipliers past the base width)."""
    jm, jparams, jmeta, tm, tparams, tmeta = _mixer(width=2.0)
    rng = np.random.default_rng(10)
    x = _rand(rng, 2, 19, jm.cfg.d_model)
    w = _rand(rng, 2, 19, jm.cfg.d_model)
    act = j_activation("gelu")

    def jf(p, xx):
        out, _ = jrglru.rglru_block(jm.cfg, p, jmeta, xx, jm.p13n, act)
        return jnp.sum(out * w)

    jgrads = jax.jit(jax.grad(jf, argnums=(0, 1)))(jparams, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = trglru.rglru_block(tm.cfg, leaves, tmeta, xt, tm.p13n)
    (out * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, jgrads[1], **GRAD_TOL)
    for k, g in jgrads[0].items():
        _close(leaves[k].grad, g, **GRAD_TOL, msg=k)
        assert leaves[k].grad.abs().max().item() > 0, k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
def test_logits_match_the_reference(width):
    """Full-sequence logits over 40 positions (past the window of 8), the
    groups and the tail, at atol = rtol = 1e-4."""
    jm, jp, tm, tp = _pair(width)
    toks = np.random.default_rng(11).integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tl, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(tl, jl, **LOGIT_TOL)


@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
@pytest.mark.parametrize("mode", sorted(TRAIN_BARS))
def test_loss_and_grads_match_the_reference(mode, width):
    """loss_fn and every gradient (the tail's too) against
    jit(value_and_grad(loss_fn)); under amp the local layer's attention
    takes the flash kernels' path on both sides (here their plain
    versions, the reference's interpret-mode contract) and the readout
    rounds (bf16) or quantizes (int8)."""
    jm, jp, tm, tp = _pair(width, amp="" if mode == "f32" else mode)
    batch = _batch(jm.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    loss_tol, grad_tol, share = TRAIN_BARS[mode]
    np.testing.assert_allclose(float(tloss), float(jloss), **loss_tol)
    want = _to_torch(jgrads)
    assert sorted(tgrads) == sorted(want)
    assert any(n.startswith("tail.1_recurrent.") for n in want)
    for name, w in want.items():
        g = tgrads[name].detach()
        torch.testing.assert_close(g, w, **grad_tol, msg=name)
        if share is not None:
            assert (g - w).abs().max().item() <= share * w.abs().max().item() + 1e-7, name
        if ".mixer." in name and not name.endswith(("conv_b", "b_a", "b_x")):
            assert g.abs().max().item() > 0, name


@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
def test_loss_and_grads_under_sp_match_the_reference(width):
    """The same under SP in f32: every multiplier 1 and the init stds
    SP's, the tail's tensors included."""
    jm, jp, tm, tp = _pair(width, p13n="sp")
    batch = _batch(jm.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    loss_tol, grad_tol, _ = TRAIN_BARS["f32"]
    np.testing.assert_allclose(float(tloss), float(jloss), **loss_tol)
    want = _to_torch(jgrads)
    assert sorted(tgrads) == sorted(want)
    for name, w in want.items():
        torch.testing.assert_close(tgrads[name].detach(), w, **grad_tol, msg=name)


def test_decode_matches_the_forward_and_the_reference():
    """A prefill of 16 with a cache for 40, then decode_step at positions
    16..38: the local layer's ring of 8 wraps.  Each row's logits against
    one forward over the 40 tokens (rows 15..38) within 1e-4 of max
    |logit|; the prefill's caches (the groups' stacked h, conv and ring,
    the tail's h and conv) against the reference's prefill at the f32
    tiers, their layout the reference's and cache_shapes'; each decode
    step's logits against the reference's decode_step."""
    jm, jp, tm, tp = _pair()
    B, P, T = 2, 16, 40
    toks = np.random.default_rng(12).integers(0, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    seq = torch.from_numpy(toks).long()
    full, _ = tm.forward(tp, seq)
    last, cache = tm.prefill(tp, seq[:, :P], cache_len=T)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :P]), cache_len=T)
    _close(last, jlast, **LOGIT_TOL)
    got = flatten_tree(cache, torch.is_tensor)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jcache),
                        lambda x: isinstance(x, np.ndarray))
    assert sorted(got) == sorted(want)
    assert "tail.1_recurrent.mixer.h" in got and "groups.2_local.attn.pos" in got
    for name, w in want.items():
        if name.endswith("pos"):
            np.testing.assert_array_equal(got[name].numpy(), w)
        else:
            _close(got[name], w, **F32, msg=name)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in got.items()}
    assert shapes == flatten_tree(tm.cache_shapes(B, T), lambda x: isinstance(x, tuple)
                                  and isinstance(x[0], tuple))
    rows = [last]
    jdec = jax.jit(jm.decode_step)
    for p in range(P, T - 1):
        pos = np.full((B, 1), p, np.int32)
        d, cache = tm.decode_step(tp, seq[:, p:p + 1], torch.from_numpy(pos), cache)
        jd, jcache = jdec(jp, jnp.asarray(toks[:, p:p + 1]), jnp.asarray(pos), jcache)
        _close(d, jd, **LOGIT_TOL)
        rows.append(d[:, 0])
    err = (torch.stack(rows, 1) - full[:, P - 1:T - 1]).abs().max().item()
    assert err <= DECODE_BAR * full.abs().max().item(), err
    # the tail's state was carried: the last step's h equals the reference's
    _close(cache["tail"]["1_recurrent"]["mixer"]["h"],
           jcache["tail"]["1_recurrent"]["mixer"]["h"], **F32)


def test_init_rglru_cache_is_the_references_and_the_models():
    """init_rglru_cache: the reference's shapes and dtypes (h f32, conv in
    the given dtype), zero; the same leaves as a tail block's slot of
    Model.init_cache."""
    _, _, tm, _ = _pair()
    got = trglru.init_rglru_cache(tm.cfg, 3, dtype=torch.bfloat16)
    want = jrglru.init_rglru_cache(tm.cfg, 3, dtype=jnp.bfloat16)
    assert sorted(got) == sorted(want) == ["conv", "h"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape and not got[k].any(), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
    slot = tm.init_cache(3, 10)["tail"]["0_recurrent"]["mixer"]
    f32 = trglru.init_rglru_cache(tm.cfg, 3)
    assert {k: (t.shape, t.dtype) for k, t in slot.items()} == \
        {k: (t.shape, t.dtype) for k, t in f32.items()}


def test_decode_from_an_empty_cache_equals_the_forward():
    """init_cache (the reference's layout: h f32, conv in the activation
    dtype, groups and tail) and decode_step from position 0, token by
    token past the ring's wrap, equals the forward."""
    _, _, tm, tp = _pair()
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, tm.cfg.vocab_size, (2, 20)).astype(np.int64))
    full, _ = tm.forward(tp, toks)
    cache = tm.init_cache(2, 20)
    assert cache["tail"]["0_recurrent"]["mixer"]["h"].dtype == torch.float32
    assert cache["groups"]["0_recurrent"]["mixer"]["conv"].shape == (1, 2, 3, 64)
    rows = []
    for p in range(20):
        d, cache = tm.decode_step(tp, toks[:, p:p + 1],
                                  torch.full((2, 1), p, dtype=torch.int32), cache)
        rows.append(d[:, 0])
    err = (torch.stack(rows, 1) - full).abs().max().item()
    assert err <= DECODE_BAR * full.abs().max().item(), err


def test_collect_stats_cover_the_groups_and_the_tail():
    """The µP-health statistics of a train forward: the residual stream
    after every group block, (n_groups,), and after each tail block, 0-d
    (``block/tail/<i>_<kind>``), equal to the reference's."""
    jm, jp, tm, tp = _pair()
    batch = _batch(jm.cfg.vocab_size)
    _, jst = jm.loss_fn(jp, _to(batch, "jax"), collect_stats=True)
    _, tst = tm.loss_fn(tp, _to(batch, "torch"), collect_stats=True)
    assert sorted(tst) == sorted(jst)
    assert {"block/tail/0_recurrent", "block/tail/1_recurrent", "block/2_local"} <= set(tst)
    assert tst["block/tail/1_recurrent"].dim() == 0
    assert tuple(tst["block/0_recurrent"].shape) == (tm.cfg.n_groups,)
    for k in jst:
        _close(tst[k].detach(), jst[k], atol=1e-4, rtol=1e-4)


def test_telemetry_step_keys_and_values_equal_the_reference():
    """The telemetry train step (obs/telemetry.py) on the smoke: the
    reference's record keys in its order, the tail's included
    (``block/tail/<i>_recurrent``, ``u2w/tail/<i>_recurrent/...``), each
    value at tests/test_torch_obs.py's tolerances (statistics 1e-4,
    update ratios atol 2e-4 / rtol 1e-3)."""
    jm, jp, tm, tp = _pair()
    jopt = JOptimizer.create("adam", lr=1e-2, parametrization=jm.p13n, meta=jm.meta)
    topt = TOptimizer.create("adam", 1e-2, tm.p13n, tm.meta)
    batch = _batch(jm.cfg.vocab_size)
    _, _, tm1 = tmake_step(tm, topt, telemetry=True)(dict(tp), topt.init(tp),
                                                     _to(batch, "torch"))
    _, _, jm1 = jax.jit(jmake_step(jm, jopt, telemetry=True))(jp, jopt.init(jp),
                                                              _to(batch, "jax"))
    jaux = jax.device_get(jm1["obs"])
    taux = ttelemetry.to_host(tm1["obs"])
    assert list(taux) == list(jaux)
    assert "block/tail/1_recurrent" in taux and "u2w/tail/0_recurrent/mixer/lam" in taux
    for k, want in jaux.items():
        tol = dict(atol=2e-4, rtol=1e-3) if k.startswith("u2w/") else dict(atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(taux[k], np.asarray(want), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the train CLI, the batched sweep and the coord check
# ---------------------------------------------------------------------------

def test_train_cli_first_loss_matches_the_reference(monkeypatch):
    """The port's train CLI on recurrentgemma's smoke, its Model.init
    standing in for the reference's draw: the first loss within 1e-5 of
    the reference CLI's, the losses finite
    and falling."""

    def reference_init(self, seed=0, dtype=torch.float32):
        jcfg = JModelConfig(**dataclasses.asdict(self.cfg))
        return _to_torch(jbuild(jcfg).init(jax.random.PRNGKey(seed)))

    monkeypatch.setattr(tmodel.Model, "init", reference_init)
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch-size", "2",
            "--seq-len", "32"]
    got = ttrain.main([*argv, "--device", "cpu"])
    want = jtrain.main(argv)
    assert got["steps_run"] == 3 and all(math.isfinite(v) for v in got["losses"])
    assert got["losses"][-1] < got["losses"][0]
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)


KW = dict(steps=6, batch_size=4, seq_len=32)
# tests/test_torch_ssd.py's candidates, the third at lr 5e-3: at lr 2e-2
# (or 1e-2) with sigma 2 the smoke's trajectory is chaotic in f32 -- the
# reference's own serial loop, its init moved by 1e-7 relative, ends steps
# 3-5 up to 7e-3 apart, so no two roundings could agree at 2e-3; at 5e-3
# the same moves stay within 3.5e-4
CANDIDATES = [dict(lr=5e-3), dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
              dict(lr=5e-3, sigma=2.0, alpha_embed=0.5)]


def test_batched_sweep_matches_the_reference_and_serial():
    """train_proxy_batched (one vmapped step for the three candidates, the
    RG-LRU's doubling scan under torch.func.vmap) on the reference's init
    against the reference's engine and against the port's serial loop."""
    space = mup_space()
    cands = [space.hparams(**c) for c in CANDIDATES]
    model = jbuild(j_smoke(ARCH, dtype="float32"))
    stacked = jax.vmap(lambda r, s: jinit_params(r, model.meta, model.p13n, sigma=s))(
        jtuning.candidate_rngs(0, len(cands)),
        jnp.asarray([h.sigma for h in cands], jnp.float32))
    init = params_from_numpy(flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                                          lambda x: isinstance(x, np.ndarray)),
                             device="cpu")
    assert any(n.startswith("tail.") for n in init)
    got = ttuning.train_proxy_batched(t_smoke(ARCH), cands, device="cpu",
                                      init_fn=lambda gens, hp: init, **KW)
    want = jtuning.train_proxy_batched(j_smoke(ARCH), cands, **KW)
    assert got.active.all() and got.steps_run == KW["steps"]
    np.testing.assert_allclose(got.curves, want.curves, rtol=SWEEP_RTOL)
    assert got.best_index == want.best_index
    ser = ttuning.train_proxy_serial(t_smoke(ARCH), cands, device="cpu",
                                     init_fn=lambda gens, hp: init, **KW)
    np.testing.assert_allclose(got.curves, ser.curves, rtol=SWEEP_RTOL)


def _cc_close(got, want, what, noisy_start=False):
    """Records equal at the coord check's tolerances.  ``noisy_start``: at
    step 0 the weights are the init, so every ``.delta`` is 0; the port's
    is exactly 0, the reference's is the rounding gap between its vmapped
    and its unbatched forward and is held to 1e-6 of the coordinate size
    instead."""
    assert sorted(got) == sorted(want), what
    for w in want:
        for t, (g, r) in enumerate(zip(got[w], want[w])):
            assert sorted(g) == sorted(r), (what, w, t)
            for k in r:
                if noisy_start and t == 0 and k.endswith(".delta"):
                    assert not np.asarray(g[k]).any(), (what, w, k)
                    size = np.abs(np.asarray(r[k[:-len(".delta")]])).max()
                    assert np.abs(np.asarray(r[k])).max() <= 1e-6 * size, (what, w, k)
                    continue
                np.testing.assert_allclose(np.asarray(g[k]), np.asarray(r[k]), rtol=CC_RTOL,
                                           atol=CC_ATOL, err_msg=f"{what} w={w} t={t} {k}")


def test_coord_check_batched_on_the_recurrentgemma_family():
    """Two widths x two lrs, batched over the lrs: against the port's one-lr
    runs and against the reference's coord_check_batched records."""
    widths_f, lrs, steps = (1.0, 2.0), (1e-2, 1e-1), 2
    jbase = j_smoke(ARCH, dtype="float32")
    tbase = t_smoke(ARCH, dtype="float32")

    def jmake(i):
        model = jbuild(jbase.scaled(widths_f[i]))
        return (model.init(jax.random.PRNGKey(0)), model.meta,
                lambda p, b: model.loss_fn(p, b, collect_acts=True))

    inits = {}

    def tmake(i):
        if i not in inits:   # the reference's draw, made once a width
            inits[i] = jbuild(jbase.scaled(widths_f[i])).init(jax.random.PRNGKey(0))
        params = _to_torch(inits[i])
        model = tbuild(tbase.scaled(widths_f[i]), device="cpu")
        return params, model.meta, lambda p, b: model.loss_fn(p, b, collect_acts=True)

    pipe = jpipeline(jbase.vocab_size, 32, 4, seed=0)
    raw = [pipe.batch(t) for t in range(steps)]
    widths = list(range(len(widths_f)))
    got = tcoord.coord_check_batched(tmake, widths, [_to(b, "torch") for b in raw],
                                     tresolve("mup"), lrs=lrs)
    for i, lr in enumerate(lrs):
        one = tcoord.coord_check(tmake, widths, [_to(b, "torch") for b in raw],
                                 tresolve("mup"), lr=lr)
        _cc_close(got.candidate_view(i).records, one.records, f"lr {lr}")
    want = jcoord.coord_check_batched(jmake, widths, [_to(b, "jax") for b in raw],
                                      jresolve("mup"), lrs=lrs)
    _cc_close(got.records, want.records, "reference", noisy_start=True)
