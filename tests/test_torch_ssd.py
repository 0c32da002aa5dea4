"""The Mamba-2 SSD block in the port against the reference: mamba2-130m's
configs and parameter metas, the SSD pieces (``_segsum``, ``_causal_conv``,
``ssd_chunked``, ``ssd_decode_step``, ``ssd_block`` and its gradients), the
model's logits, loss and gradients (at the smoke's width and at
``.scaled(2)``, where the µP multipliers of ``w_B`` / ``w_C`` are not 1),
decode against the full forward, the train CLI's first loss on the
reference's weights, and the batched sweep and coord check on mamba2's
smoke family against their serial runs.

The SSD mixer reaches no Pallas kernel in the reference, so its CPU path
is the reference itself.  Weights come from the reference's init and move
over by ``convert.params_from_numpy``; inputs are drawn with numpy from
fixed seeds.  Tolerances: the f32 tiers (values atol 2e-5 / rtol 1e-5 a
piece, 1e-4 for logits, gradients atol 2e-4 / rtol 1e-3), the loss within
1e-5 relative, decode logits within 1e-4 of max |logit| (the reference's
bar in tests/test_smoke_archs.py), the sweep at the reference's 2e-3.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.transformer import _unstack_meta as j_unstack_meta  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import coord_check as tcoord  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.hpspace import mup_space  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.core.parametrization import resolve as tresolve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402

ARCH = "mamba2-130m"
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


def _pair(width=1.0, amp="", **over):
    """(reference model, its params, port model, the same params) of the
    smoke at ``width`` times its widths (its own µP base)."""
    over = dict(dtype="float32", amp=amp, **over)
    jcfg, tcfg = j_smoke(ARCH, **over), t_smoke(ARCH, **over)
    if width != 1.0:
        jcfg, tcfg = jcfg.scaled(width), tcfg.scaled(width)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tbuild(tcfg, device="cpu"), _to_torch(jp)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **tol)


def _batch(V, B=2, S=48, seed=0):
    """Tokens and labels with masked (-100) positions."""
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
# configs and metas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_the_reference(size):
    """Every field the port keeps equals the reference's, the SSM fields
    and d_inner among them; 129.0 M parameters at full size."""
    t = (t_config if size == "full" else t_smoke)(ARCH)
    j = (j_config if size == "full" else j_smoke)(ARCH)
    kept = {f.name for f in dataclasses.fields(t)}
    assert {"ssm_state", "ssm_expand", "ssm_n_heads", "ssm_head_dim", "ssm_chunk",
            "conv_width"} <= kept
    for name in kept:
        assert getattr(t, name) == getattr(j, name), name
    assert t.d_inner == j.d_inner and t.param_count() == j.param_count()
    if size == "full":
        assert t.param_count() == 128_882_688
        # the proxy keeps the reference's rule: d_ff 1 (unused)
        p, q = t.scaled(0.25), j.scaled(0.25)
        assert p.d_ff == q.d_ff == 1 and p.d_inner == q.d_inner == 384


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
    """Every tensor's name, shape, base shape, width axes, fans, role, init
    kind, init std, forward multiplier and LR multipliers equal the
    reference's, under µP and SP; w_B / w_C are output-like (their µP
    multiplier 1/width_mult past the base width)."""
    get_t, get_j = (t_config, j_config) if size == "full" else (t_smoke, j_smoke)
    tcfg, jcfg = get_t(ARCH, n_layers=2), get_j(ARCH, n_layers=2)
    if width != 1.0:
        tcfg, jcfg = tcfg.scaled(width), jcfg.scaled(width)
    tmeta = tbuild(tcfg, device="cpu").flat_meta
    jmeta = j_flatten_meta(jbuild(jcfg).meta)
    assert sorted(tmeta) == sorted(jmeta)
    for p13n in ("mup", "sp"):
        for name in jmeta:
            assert (_meta_fields(tmeta[name], tresolve(p13n))
                    == _meta_fields(jmeta[name], jresolve(p13n))), (p13n, name)
    mult = _meta_fields(tmeta["groups.0_ssd.mixer.w_B"], tresolve("mup"))["mult"]
    assert mult == pytest.approx(1.0 / width)


def test_init_statistics():
    """The port's own init of mamba2-130m at full width (2 of its 24 layers):
    each normal tensor at its rule's init_std (within 5%, or four times the
    sample std's spread for the 48 entries of A_log), the biases and gains
    zero and D_skip one."""
    model = tbuild(t_config(ARCH, n_layers=2), device="cpu")
    params = model.init(0)
    for name, m in model.flat_meta.items():
        t = params[name]
        if m.init == "zeros":
            assert not t.any(), name
        elif m.init == "ones":
            assert name.endswith("D_skip") and bool((t == 1).all()), name
        else:
            # the sample std's relative spread is 1 / sqrt(2n): A_log has 48
            std = t.std().item()
            rel = max(0.05, 4 / math.sqrt(2 * t.numel()))
            assert std == pytest.approx(m.rule(model.p13n).init_std, rel=rel), name
    assert model.flat_meta["groups.0_ssd.mixer.D_skip"].init == "ones"


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------

def test_segsum_matches_the_reference():
    """The difference of cumsums, -inf above the diagonal, as the reference
    rounds it."""
    a = -np.abs(_rand(np.random.default_rng(0), 2, 3, 16))
    got = tssm._segsum(torch.from_numpy(a))
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    assert bool(torch.isneginf(got).eq(torch.from_numpy(np.isneginf(want))).all())
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], **F32)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_causal_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(1)
    u, w, b = _rand(rng, 2, 9, 20), _rand(rng, 4, 20, scale=0.5), _rand(rng, 20)
    st = _rand(rng, 2, 3, 20) if with_state else None
    y, s = tssm._causal_conv(*map(torch.from_numpy, (u, w, b)),
                             None if st is None else torch.from_numpy(st))
    jy, js = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    _close(y, jy, **F32)
    _close(s, js, **F32)


def _ssd_inputs(seed, B=2, S=48, nh=4, hd=8, n=6):
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, S, nh, hd)
    dt = np.log1p(np.exp(_rand(rng, B, S, nh))).astype(np.float32)
    A = -np.exp(_rand(rng, nh, scale=0.5)).astype(np.float32)
    return x, dt, A, _rand(rng, B, S, n), _rand(rng, B, S, n), _rand(rng, B, nh, hd, n)


@pytest.mark.parametrize("given_h0", [False, True], ids=["h0_none", "h0_given"])
def test_ssd_chunked_matches_the_reference(given_h0):
    """S 48 over chunks of 16: three chunks, so the inter-chunk recurrence
    runs twice; the output and the last state at the f32 tiers."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2)
    h0 = h0 if given_h0 else None
    y, h = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 16,
                            h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16,
                              h0=None if h0 is None else jnp.asarray(h0))
    _close(y, jy, **F32)
    _close(h, jh, **F32)


def test_ssd_chunked_refuses_a_ragged_sequence_like_the_reference():
    """Past one chunk a sequence must be a whole number of chunks, in both
    packages (the reference asserts, the port raises naming S and Q); a
    sequence shorter than one chunk is one chunk."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(3, S=20)
    with pytest.raises(ValueError, match="S=20.*Q=16"):
        tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 16)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16)
    y, _ = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 32)
    jy, _ = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 32)
    _close(y, jy, **F32)


def test_ssd_decode_step_matches_the_reference():
    x, dt, A, Bm, Cm, h = _ssd_inputs(4, S=1)
    y, hn = tssm.ssd_decode_step(*map(torch.from_numpy, (x, dt, A, Bm, Cm, h)))
    jy, jhn = jssm.ssd_decode_step(*map(jnp.asarray, (x, dt, A, Bm, Cm, h)))
    _close(y, jy, **F32)
    _close(hn, jhn, **F32)


def _block_pair(width=1.0):
    jm, jp, tm, tp = _pair(width)
    key = "0_ssd"
    jparams = jax.tree_util.tree_map(lambda a: a[0], jp["groups"][key]["mixer"])
    tparams = {n.split(".")[-1]: t[0] for n, t in tp.items()
               if n.startswith(f"groups.{key}.mixer.")}
    return jm, jparams, tm, tparams, tm.layer_meta[key]["mixer"]


def test_ssd_block_and_its_gradients_match_the_reference():
    """ssd_block's output and the gradients of sum(out * w) with respect to
    its input and every weight, against jax.grad, at .scaled(2) (w_B / w_C's
    multiplier 1/2); dt_bias moved off zero so that softplus is not at 0."""
    jm, jparams, tm, tparams, tmeta = _block_pair(2.0)
    rng = np.random.default_rng(5)
    jparams = dict(jparams, dt_bias=jnp.asarray(_rand(rng, *jparams["dt_bias"].shape)))
    tparams = dict(tparams, dt_bias=torch.from_numpy(np.array(jparams["dt_bias"])))
    x = _rand(rng, 2, 32, jm.cfg.d_model)
    w = _rand(rng, 2, 32, jm.cfg.d_model)
    jmeta = {k: j_unstack_meta(m) for k, m in jm.meta["groups"]["0_ssd"]["mixer"].items()}

    def jf(p, xx):
        out, _ = jssm.ssd_block(jm.cfg, p, jmeta, xx, jm.p13n)
        return jnp.sum(out * w), out

    (jval, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, cache = tssm.ssd_block(tm.cfg, leaves, tmeta, xt, tm.p13n)
    assert cache is None
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), jout, **LOGIT_TOL)
    _close(xt.grad, jgrads[1], **GRAD_TOL)
    for k, g in jgrads[0].items():
        _close(leaves[k].grad, g, **GRAD_TOL, msg=k)
        assert leaves[k].grad.abs().max().item() > 0, k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
def test_logits_match_the_reference(width):
    """Full-sequence logits over three chunks at atol = rtol = 1e-4."""
    jm, jp, tm, tp = _pair(width)
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (2, 48)).astype(np.int32)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(tl, jl, **LOGIT_TOL)


@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
@pytest.mark.parametrize("mode", sorted(TRAIN_BARS))
def test_loss_and_grads_match_the_reference(mode, width):
    """loss_fn and every gradient against jit(value_and_grad(loss_fn)); under
    amp only the readout rounds (bf16) or quantizes (int8): mamba2 has no
    attention for the flash path."""
    jm, jp, tm, tp = _pair(width, amp="" if mode == "f32" else mode)
    batch = _batch(jm.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    loss_tol, grad_tol, share = TRAIN_BARS[mode]
    np.testing.assert_allclose(float(tloss), float(jloss), **loss_tol)
    want = _to_torch(jgrads)
    assert sorted(tgrads) == sorted(want)
    for name, w in want.items():
        g = tgrads[name].detach()
        torch.testing.assert_close(g, w, **grad_tol, msg=name)
        if share is not None:
            assert (g - w).abs().max().item() <= share * w.abs().max().item() + 1e-7, name
        if ".mixer." in name and not name.endswith(("dt_bias", "conv_b", "norm_gain")):
            assert g.abs().max().item() > 0, name


def test_decode_matches_the_forward_and_the_reference():
    """A prefill of 32 (two chunks) with a cache for 48, then decode_step at
    positions 32..46: each row's logits against one forward over the 48
    tokens (rows 31..46) within 1e-4 of max |logit|, the prefill's h and
    conv state against the reference's prefill at the f32 tiers, and each
    decode step's logits against the reference's decode_step."""
    jm, jp, tm, tp = _pair()
    B, P, T = 2, 32, 48
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    seq = torch.from_numpy(toks).long()
    full, _ = tm.forward(tp, seq)
    last, cache = tm.prefill(tp, seq[:, :P], cache_len=T)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :P]), cache_len=T)
    _close(last, jlast, **LOGIT_TOL)
    for name in ("h", "conv"):
        _close(cache["groups"]["0_ssd"][name], jcache["groups"]["0_ssd"][name], **F32)
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in flatten_tree(cache, torch.is_tensor).items()}
    want_shapes = flatten_tree(tm.cache_shapes(B, T), lambda x: isinstance(x, tuple)
                               and isinstance(x[0], tuple))
    assert shapes == want_shapes
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


def test_decode_from_an_empty_cache_equals_the_forward():
    """init_cache (the reference's layout: h f32, conv in the activation
    dtype) and decode_step from position 0, token by token, equals the
    forward."""
    _, _, tm, tp = _pair()
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int64))
    full, _ = tm.forward(tp, toks)
    cache = tm.init_cache(2, 12)
    assert cache["groups"]["0_ssd"]["h"].dtype == torch.float32
    rows = []
    for p in range(12):
        d, cache = tm.decode_step(tp, toks[:, p:p + 1],
                                  torch.full((2, 1), p, dtype=torch.int32), cache)
        rows.append(d[:, 0])
    err = (torch.stack(rows, 1) - full).abs().max().item()
    assert err <= DECODE_BAR * full.abs().max().item(), err


# ---------------------------------------------------------------------------
# f32 against float64 at full width: the witness for chip_smoke.py's
# serve_mamba2, which prints the f32 forward's distance from float64
# ---------------------------------------------------------------------------

def _ssd_recurrence_f64(x, dt, A, Bm, Cm):
    """The SSD one position at a time in float64 numpy (h_t = exp(dt_t A)
    h_{t-1} + (dt_t x_t) B_t^T, y_t = h_t C_t): neither package's code."""
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in (x, dt, A, Bm, Cm))
    h = np.zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]))
    y = np.empty(x.shape)
    for t in range(x.shape[1]):
        a = np.exp(dt[:, t] * A)
        h = a[:, :, None, None] * h + np.einsum("bhp,bn->bhpn",
                                                x[:, t] * dt[:, t, :, None], Bm[:, t])
        y[:, t] = np.einsum("bhpn,bn->bhp", h, Cm[:, t])
    return y


@pytest.mark.parametrize("dt_range", [(0.05, 0.5), (2.0, 5.0)], ids=["weak", "strong"])
def test_f32_chunked_ssd_drifts_from_float64_as_the_references(dt_range):
    """One layer's ssd_chunked at mamba2-130m's widths (24 heads of 64,
    state 128, chunks of 256, three of them) with each head's step size
    near-constant over the sequence (a repeated token): with strong decays
    the log-decay sums reach ~1,700 over a chunk.  Both packages' f32
    chunked SSD against a float64 recurrence: the port's within twice the
    reference's distance (measured: weak 3.28e-6, the reference's 4.05e-6;
    strong 3.09e-6, the reference's 2.16e-6, of max |y|), and the port's
    float64 chunked SSD within 1e-10 of the recurrence."""
    rng = np.random.default_rng(11)
    B, S, nh, hd, n, Q = 1, 768, 24, 64, 128, 256
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.broadcast_to(rng.uniform(*dt_range, (B, 1, nh)), (B, S, nh))
    dt = (dt * (1 + 0.01 * rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = -rng.uniform(0.5, 1.6, nh).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, n)).astype(np.float32) for _ in range(2))
    exact = _ssd_recurrence_f64(x, dt, A, Bm, Cm)
    scale = np.abs(exact).max()
    ref = np.asarray(jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), Q)[0])
    port = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), Q)[0].numpy()
    port64 = tssm.ssd_chunked(*(torch.from_numpy(a).double() for a in (x, dt, A, Bm, Cm)),
                              Q)[0].numpy()
    d_ref, d_port, d64 = (np.abs(y - exact).max() / scale for y in (ref, port, port64))
    print(f"ssd_chunked from float64, of max |y| {scale:.4g}: reference f32 {d_ref:.3g}, "
          f"port f32 {d_port:.3g}, port float64 {d64:.3g}")
    assert d_port <= 2 * d_ref, (d_port, d_ref)
    assert d64 <= 1e-10, d64


def test_f32_forward_drifts_from_float64_as_the_references():
    """mamba2-130m at full width over 12 of its 24 layers (the sandbox runs
    no full-size model), the reference's init: a prompt of 512 tokens and
    256 tokens greedily generated by the port (the row repeats one token,
    as the card's served rows do), then logits at rows 511-766 of one
    forward over the 768 tokens.  The reference's f32 forward (its SSD is
    f32 only) and the port's, each against the port's float64 forward: the
    port's within three times the reference's distance (measured 1.39e-5,
    the reference's 1.54e-5 of max |logit|).  The float64 forward is
    checked against the float64 decode over the same rows (1e-10)."""
    from repro_torch.launch.serve import generate

    L, B, P, G = 12, 1, 512, 256
    jm = jbuild(j_config(ARCH, n_layers=L, dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = _to_torch(jp)
    tm = tbuild(t_config(ARCH, n_layers=L, dtype="float32"), device="cpu")
    tm64 = tbuild(t_config(ARCH, n_layers=L, dtype="float64"), device="cpu")
    p64 = {k: v.double() for k, v in tp.items()}
    prompts = np.random.default_rng(12).integers(0, tm.cfg.vocab_size, (B, P))
    rows = np.arange(P - 1, P + G - 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)    # the port's share of the test's time
    try:
        with torch.no_grad():
            gen = generate(tm, tp, torch.from_numpy(prompts), G, eos_token_id=-1).numpy()
            toks = np.concatenate([prompts, gen], axis=1).astype(np.int32)
            seq = torch.from_numpy(toks).long()
            port = tm.forward(tp, seq)[0][:, rows].double().numpy()
            exact = tm64.forward(p64, seq)[0][:, rows]
            last, cache = tm64.prefill(p64, seq[:, :P], cache_len=P + G)
            dec = [last]
            for p in range(P, P + G - 1):
                d, cache = tm64.decode_step(p64, seq[:, p:p + 1],
                                            torch.full((B, 1), p, dtype=torch.int32), cache)
                dec.append(d[:, 0])
    finally:
        torch.set_num_threads(threads)
    ref = np.asarray(jm.forward(jp, jnp.asarray(toks))[0])[:, rows]
    scale = exact.abs().max().item()
    d64 = (torch.stack(dec, 1) - exact).abs().max().item() / scale
    exact = exact.numpy()
    d_ref, d_port = (np.abs(y - exact).max() / scale for y in (ref, port))
    print(f"logits from float64 at {L} layers, of max |logit| {scale:.4g}: reference f32 "
          f"{d_ref:.3g}, port f32 {d_port:.3g}; the float64 decode {d64:.3g}; distinct "
          f"generated tokens a row {[len(set(r)) for r in gen]}")
    assert d_port <= 3 * d_ref, (d_port, d_ref)
    assert d64 <= 1e-10, d64


def test_collect_stats_cover_the_ssd_blocks():
    """The µP-health statistics of a train forward: the residual stream
    after every ssd block, (n_groups,), equal to the reference's."""
    jm, jp, tm, tp = _pair()
    batch = _batch(jm.cfg.vocab_size)
    _, jst = jm.loss_fn(jp, _to(batch, "jax"), collect_stats=True)
    _, tst = tm.loss_fn(tp, _to(batch, "torch"), collect_stats=True)
    assert sorted(tst) == sorted(jst) and "block/0_ssd" in tst
    assert tuple(tst["block/0_ssd"].shape) == (tm.cfg.n_groups,)
    for k in jst:
        _close(tst[k].detach(), jst[k], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the train CLI, the batched sweep and the coord check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", ["", "int8"], ids=["f32", "int8"])
def test_train_cli_first_loss_matches_the_reference(amp, monkeypatch):
    """The port's train CLI on mamba2's smoke, its Model.init standing in
    for the reference's draw: the first loss within 1e-5 of the reference
    CLI's, the losses finite."""

    def reference_init(self, seed=0, dtype=torch.float32):
        jcfg = JModelConfig(**dataclasses.asdict(self.cfg))
        return _to_torch(jbuild(jcfg).init(jax.random.PRNGKey(seed)))

    monkeypatch.setattr(tmodel.Model, "init", reference_init)
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch-size", "2",
            "--seq-len", "32"] + (["--amp", amp] if amp else [])
    got = ttrain.main([*argv, "--device", "cpu"])
    want = jtrain.main(argv)
    assert got["steps_run"] == 3 and all(math.isfinite(v) for v in got["losses"])
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)


KW = dict(steps=6, batch_size=4, seq_len=32)
CANDIDATES = [dict(lr=5e-3), dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
              dict(lr=2e-2, sigma=2.0, alpha_embed=0.5)]


def test_batched_sweep_matches_the_reference_and_serial():
    """train_proxy_batched (one vmapped step for the three candidates) on the
    reference's init against the reference's engine and against the port's
    serial loop."""
    space = mup_space()
    cands = [space.hparams(**c) for c in CANDIDATES]
    model = jbuild(j_smoke(ARCH, dtype="float32"))
    stacked = jax.vmap(lambda r, s: jinit_params(r, model.meta, model.p13n, sigma=s))(
        jtuning.candidate_rngs(0, len(cands)),
        jnp.asarray([h.sigma for h in cands], jnp.float32))
    init = params_from_numpy(flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                                          lambda x: isinstance(x, np.ndarray)),
                             device="cpu")
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
    and its unbatched forward (2.2e-6 on the logits, whose coordinate size
    is ~10 there) and is held to 1e-6 of the coordinate size instead."""
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


def test_coord_check_batched_on_the_mamba2_family():
    """Two widths x two lrs, batched over the lrs: against the port's one-lr
    runs and against the reference's coord_check_batched records."""
    widths_f, lrs, steps = (1.0, 2.0), (1e-2, 1e-1), 2
    jbase = j_smoke(ARCH, dtype="float32")
    tbase = t_smoke(ARCH, dtype="float32")

    def jmake(i):
        model = jbuild(jbase.scaled(widths_f[i]))
        return (model.init(jax.random.PRNGKey(0)), model.meta,
                lambda p, b: model.loss_fn(p, b, collect_acts=True))

    def tmake(i):
        params = _to_torch(jbuild(jbase.scaled(widths_f[i])).init(jax.random.PRNGKey(0)))
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
