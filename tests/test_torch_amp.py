"""The port's mixed-precision training path (``--amp bf16``) against the
reference: the plain attention (B5-B7's plain version), ``quant_matmul``,
``loss_fn`` and its gradients, and train steps, on the same numpy inputs and
weights.

On the CPU the port's ``ops.attention`` runs its plain version
(``kernels/ref.py``: ``attention_ref``, or ``attention_policy_ref`` under an
active policy), differentiated by autograd.  It is held against the
reference's Pallas flash-attention kernels in interpret mode (128 x 128
tiles, the blocks the reference's model runs them at, ``jax.vjp``) and
against the reference's jnp plain versions.  The plain versions at the CUDA
kernels' own contract (``ref.flash_fwd_ref``: online softmax over 128-key
tiles with the tile skip; ``ref.flash_bwd_ref``:
p recomputed from lse, ds = p (dp - delta); both rounding each tile-matmul
operand where the kernels round it) are held to the interpret-mode kernel
too, and mutants of them fail: no ``alpha`` rescale, no causal mask, no
``delta``, and, in the bf16 mode, f32 operands, p rounded after
normalisation, ds or the p of dv left unrounded.

Tolerances (docs/kernels.md tiers).  The plain attention against the
interpret-mode kernel: f32 forward atol 2e-5, gradients atol 2e-4 / rtol
1e-3; bf16 policy forward atol 2e-2, gradients atol 5e-2 / rtol 5e-2.  The
two round at different places: the kernel rounds the unnormalized p of each
tile and forms delta = rowsum(do * o), the plain version rounds the
normalized p and forms delta from p and dp = do vᵀ of the rounded do and v
(the scale is a power of two, so rounding q * scale or q is the same).
Against the reference's plain version, which rounds at its places: f32
forward atol 2e-6, gradients atol 2e-5 / rtol 1e-4; bf16 forward atol 1e-2
and gradients atol 2e-2 / rtol 1e-2 (an operand a few f32 ulps apart can
round to the neighbouring bf16 value, one bf16 ulp or 2^-8 relative: a p
near 1 that does moves o by ~4e-3 |v|).  The kernel-contract plain versions
against the interpret-mode kernel, bf16 mode: each output's max abs error
within the bf16 tier (o 2e-2, gradients 5e-2: such single roundings to the
neighbour) and its mean within 3e-5 (measured here: up to 1.1e-5; the
mutants above, on the two-tile case: 7.2e-5 and more).  The int8 mode has
its own file, tests/test_torch_amp_int8.py.
Model losses and gradients under amp: see the tests.
"""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.optimizer import Optimizer as JOptimizer  # noqa: E402
from repro.quant import QuantPolicy as JPolicy  # noqa: E402
from repro.quant import quant_matmul as jquant_matmul  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_step  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim.optimizer import Optimizer as TOptimizer  # noqa: E402
from repro_torch.quant import QuantPolicy, kernel_dot, policy_of, quant_matmul  # noqa: E402

# (forward atol, gradient atol, gradient rtol)
VS_KERNEL = {"none": (2e-5, 2e-4, 1e-3), "bf16": (2e-2, 5e-2, 5e-2)}
VS_PLAIN = {"none": (2e-6, 2e-5, 1e-4), "bf16": (1e-2, 2e-2, 1e-2)}

# B, S, H, K, d, window, softcap, scale
ATTN_CASES = {
    "mha": (2, 128, 4, 4, 32, 0, 0.0, 0.125),
    "gqa": (2, 128, 4, 2, 32, 0, 0.0, 0.125),
    "window": (1, 128, 4, 2, 32, 48, 0.0, 0.125),
    "softcap": (1, 128, 4, 2, 32, 0, 20.0, 0.5),
}
# two 128-key tiles a row, so that the online softmax rescales between them
# (at S = 128 a row has one tile at the reference model's 128 x 128 blocks)
TWO_TILE_CASES = {"gqa, 2 key tiles": (2, 256, 4, 2, 32, 0, 0.0, 0.125)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(mode):
    return None if mode == "none" else QuantPolicy(mode)


def _jpolicy(mode):
    return None if mode == "none" else JPolicy(mode)


def _attn_inputs(B, S, H, K, d, seed=0):
    """q, k, v and a cotangent of order 1, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, K, d)).astype(np.float32)
    v = rng.standard_normal((B, S, K, d)).astype(np.float32)
    do = rng.standard_normal((B, S, H, d)).astype(np.float32)
    return q, k, v, do


def _port_attention(arrays, *, scale, window, softcap, mode):
    """(o, dq, dk, dv) of the port's ops.attention on the CPU."""
    q, k, v, do = (torch.from_numpy(a.copy()) for a in arrays)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = ops.attention(q, k, v, scale=scale, causal=True, window=window,
                      softcap=softcap, policy=_policy(mode))
    grads = torch.autograd.grad(o, (q, k, v), do)
    return [o.detach().numpy()] + [g.numpy() for g in grads]


def _reference_attention(arrays, *, scale, window, softcap, mode, impl):
    """(o, dq, dk, dv) of the reference's ops.attention through jax.vjp."""
    q, k, v, do = (jnp.asarray(a) for a in arrays)

    def f(q, k, v):
        return jops.attention(q, k, v, scale=scale, causal=True, window=window,
                              softcap=softcap, block_q=128, block_k=128,
                              impl=impl, policy=_jpolicy(mode))

    o, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(do)]


def _assert_attention_close(got, want, tol):
    """o at the forward atol, dq/dk/dv at the gradient atol/rtol."""
    f_atol, g_atol, g_rtol = tol
    np.testing.assert_allclose(got[0], want[0], atol=f_atol, rtol=0, err_msg="o")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=g_atol, rtol=g_rtol, err_msg=name)


@pytest.fixture(scope="module")
def kernel_outputs():
    """The reference's interpret-mode kernel outputs, by (case, mode),
    computed once for the tests that hold something against them."""
    cache = {}

    def get(case, mode):
        if (case, mode) not in cache:
            B, S, H, K, d, window, softcap, scale = {**ATTN_CASES, **TWO_TILE_CASES}[case]
            arrays = _attn_inputs(B, S, H, K, d)
            cache[case, mode] = arrays, _reference_attention(
                arrays, scale=scale, window=window, softcap=softcap, mode=mode,
                impl="interpret")
        return cache[case, mode]

    return get


# ---------------------------------------------------------------------------
# 1-2. the plain attention against the reference's kernel and plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_matches_reference_kernel(kernel_outputs, case, mode):
    _, _, _, _, _, window, softcap, scale = ATTN_CASES[case]
    arrays, want = kernel_outputs(case, mode)
    got = _port_attention(arrays, scale=scale, window=window, softcap=softcap,
                          mode=mode)
    _assert_attention_close(got, want, VS_KERNEL[mode])


@pytest.mark.parametrize("mode", ["none", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_matches_reference_plain(case, mode):
    B, S, H, K, d, window, softcap, scale = ATTN_CASES[case]
    arrays = _attn_inputs(B, S, H, K, d, seed=1)
    kw = dict(scale=scale, window=window, softcap=softcap, mode=mode)
    got = _port_attention(arrays, **kw)
    want = _reference_attention(arrays, impl="ref", **kw)
    _assert_attention_close(got, want, VS_PLAIN[mode])


# ---------------------------------------------------------------------------
# the plain versions at the CUDA kernels' contract, and the power of the checks
# ---------------------------------------------------------------------------

ROUNDED_MAX = {"o": 2e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}   # the bf16 tiers
ROUNDED_MEAN = 3e-5


def _kernel_contract(arrays, *, scale, window, softcap, mode,
                     fwd=ref.flash_fwd_ref, bwd=ref.flash_bwd_ref, zero_delta=False):
    """(o, dq, dk, dv) composed as ops.attention composes B5-B7: the scale
    folded into q, delta = rowsum(do * o) between forward and backward, dq
    through the fold.  ``fwd`` and ``bwd`` default to the plain versions;
    ``zero_delta`` drops the delta term."""
    q, k, v, do = (torch.from_numpy(a.copy()) for a in arrays)
    kw = dict(causal=True, window=window, softcap=softcap, policy=_policy(mode))
    o, lse = fwd(q * scale, k, v, **kw)
    delta = (do * o).sum(-1).transpose(1, 2)
    if zero_delta:
        delta = torch.zeros_like(delta)
    dq, dk, dv = bwd(q * scale, k, v, do, lse, delta, **kw)
    return [o.numpy(), (dq * scale).numpy(), dk.numpy(), dv.numpy()]


def _assert_rounds_like(got, want):
    """Each output's max abs error within ROUNDED_MAX, its mean within
    ROUNDED_MEAN."""
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        diff = np.abs(g - w)
        assert diff.max() <= ROUNDED_MAX[name] and diff.mean() <= ROUNDED_MEAN, \
            (name, float(diff.max()), float(diff.mean()))


def _mutant(fn, old, new):
    """A copy of ``fn`` (a function of kernels/ref.py) with one line changed."""
    src = inspect.getsource(fn)
    assert src.count(old) == 1, old
    scope = dict(vars(ref))
    exec(src.replace(old, new), scope)
    return scope[fn.__name__]


_VISIBLE = "mask = _visible(S, T, causal, window, q.device)"
_NO_CAUSAL = "mask = _visible(S, T, False, window, q.device)"
_PV = "acc * alpha + kernel_dot(p, vh[:, :, ks], policy)"
# name: (the modes it is checked in, keyword arguments of _kernel_contract);
# a fault of the algorithm (checked in both modes) or of the rounding (bf16)
ALGORITHM = ("none", "bf16")
ROUNDING = ("bf16",)
MUTANTS = {
    "alpha": (ALGORITHM, lambda: dict(fwd=_mutant(
        ref.flash_fwd_ref, "alpha = torch.exp(m - m_new)", "alpha = torch.ones_like(m)"))),
    "causal mask": (ALGORITHM, lambda: dict(
        fwd=_mutant(ref.flash_fwd_ref, _VISIBLE, _NO_CAUSAL),
        bwd=_mutant(ref.flash_bwd_ref, _VISIBLE, _NO_CAUSAL))),
    "delta": (ALGORITHM, lambda: dict(zero_delta=True)),
    "f32 operands": (ROUNDING, lambda: dict(
        fwd=lambda *a, policy, **kw: ref.flash_fwd_ref(*a, **kw),
        bwd=lambda *a, policy, **kw: ref.flash_bwd_ref(*a, **kw))),
    "p rounded after normalisation": (ROUNDING, lambda: dict(fwd=_mutant(
        ref.flash_fwd_ref, _PV, "acc * alpha + kernel_dot(p / p.sum(-1, keepdim=True), "
        "vh[:, :, ks], policy) * p.sum(-1, keepdim=True)"))),
    "ds unrounded": (ROUNDING, lambda: dict(bwd=_mutant(
        ref.flash_bwd_ref, "kernel_dot(ds[..., ks], kh[:, :, ks], policy)",
        "kernel_dot(ds[..., ks], kh[:, :, ks].bfloat16().float(), None)"))),
    "p of dv unrounded": (ROUNDING, lambda: dict(bwd=_mutant(
        ref.flash_bwd_ref, "dog[:, :, g, qs], policy)",
        "dog[:, :, g, qs].bfloat16().float(), None)"))),
}


@pytest.mark.parametrize("mode", ["none", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES) + sorted(TWO_TILE_CASES))
def test_tiled_model_of_the_kernels_matches_reference_kernel(kernel_outputs, case, mode):
    """f32 at the f32 tiers; bf16 by _assert_rounds_like."""
    _, _, _, _, _, window, softcap, scale = {**ATTN_CASES, **TWO_TILE_CASES}[case]
    arrays, want = kernel_outputs(case, mode)
    got = _kernel_contract(arrays, scale=scale, window=window, softcap=softcap, mode=mode)
    if mode == "none":
        _assert_attention_close(got, want, VS_KERNEL[mode])
    else:
        _assert_rounds_like(got, want)


@pytest.mark.parametrize("mode", ["none", "bf16"])
def test_tiled_model_takes_a_ragged_sequence(mode):
    """S = T = 100: one full and one ragged 36-row tile on each axis,
    against the reference's plain version (its kernel needs S % 64 == 0),
    at the tiers of the plain attention against the kernel."""
    arrays = _attn_inputs(2, 100, 4, 2, 32, seed=5)
    kw = dict(scale=0.125, window=0, softcap=0.0)
    got = _kernel_contract(arrays, mode=mode, **kw)
    want = _reference_attention(arrays, impl="ref", mode=mode, **kw)
    _assert_attention_close(got, want, VS_KERNEL[mode])


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_plain_flash_path_is_the_kernel_contract(mode):
    """ops.attention_plain_flash under autograd (the kernel path's autograd
    Function over flash_fwd_ref / flash_bwd_ref) computes what
    _kernel_contract composes by hand, to f32 rounding (atol 1e-6)."""
    arrays = _attn_inputs(2, 96, 4, 2, 32, seed=7)
    kw = dict(scale=0.125, window=0, softcap=20.0)
    want = _kernel_contract(arrays, mode=mode, **kw)
    q, k, v, do = (torch.from_numpy(a.copy()) for a in arrays)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    ops.reset_launch_counts()
    o = ops.attention_plain_flash(q, k, v, causal=True, policy=_policy(mode), **kw)
    got = [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(o, (q, k, v), do)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("drop", sorted(MUTANTS))
def test_the_checks_reject_a_broken_kernel(kernel_outputs, drop):
    """A mutant of the kernel-contract plain versions fails the check
    against the reference's interpret-mode kernel: the plain attention's
    check (VS_KERNEL) for a fault in the algorithm, in both modes, and
    _assert_rounds_like for a rounding left out or misplaced in the bf16
    mode."""
    modes, make = MUTANTS[drop]
    for mode in modes:
        arrays, want = kernel_outputs("gqa, 2 key tiles", mode)
        got = _kernel_contract(arrays, scale=0.125, window=0, softcap=0.0, mode=mode,
                               **make())
        with pytest.raises(AssertionError):
            if modes is ALGORITHM:
                _assert_attention_close(got, want, VS_KERNEL[mode])
            else:
                _assert_rounds_like(got, want)


# ---------------------------------------------------------------------------
# 3. quant_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "bf16"])
@pytest.mark.parametrize("shape", [((6, 40), (40, 24)), ((2, 5, 64), (64, 48))])
def test_quant_matmul_matches_reference(mode, shape):
    """Forward and both straight-through gradients.  Both sides round the
    same f32 operands to bf16 and sum exact products in f32, so they differ
    only in summation order: atol 1e-4 / rtol 1e-5 (f32 at its tiers); the
    f32 product of the unrounded operands fails the bf16 check."""
    rng = np.random.default_rng(2)
    xs, ws = shape
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    g = rng.standard_normal(xs[:-1] + ws[-1:]).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b: jquant_matmul(a, b, _jpolicy(mode)),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = quant_matmul(tx, tw, _policy(mode))
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    assert out.dtype == torch.float32
    tol = dict(atol=2e-5, rtol=1e-5) if mode == "none" else dict(atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **tol)
    if mode == "bf16":
        f32 = (x @ w, g @ w.T, np.swapaxes(x, -1, -2) @ g)
        if x.ndim == 3:
            f32 = f32[:2] + ((x.reshape(-1, xs[-1]).T @ g.reshape(-1, ws[-1])),)
        for f, j in zip(f32, (jout, jdx, jdw)):
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(f, np.asarray(j), **tol)


def test_bf16_kernel_dot_is_exact_products_accumulated_in_f32():
    """bf16 operands, f32 output: the f32 product of the rounded operands,
    not a bf16-output matmul (which would round the sums)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 8)).astype(np.float32))
    got = kernel_dot(a, b, QuantPolicy("bf16"))
    assert got.dtype == torch.float32
    want = a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double()
    torch.testing.assert_close(got.double(), want, atol=1e-4, rtol=0)
    bf16_out = (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).double()
    assert (bf16_out - want).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# 4-6. the model and the train loop under amp
# ---------------------------------------------------------------------------

AMP_CONFIGS = {
    "mup-gpt-smoke": lambda m: m.get_smoke_config("mup-gpt").replace(
        dtype="float32", zero_init_query=False, amp="bf16"),
    "mup-gpt@0.125x": lambda m: m.get_config("mup-gpt").replace(
        n_layers=2, dtype="float32", zero_init_query=False, amp="bf16").scaled(0.125),
}


def _flat(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module", params=sorted(AMP_CONFIGS))
def amp_pair(request):
    make = AMP_CONFIGS[request.param]
    jm = jbuild(make(jconfigs))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(make(tconfigs), device="cpu")
    return jm, jp, tm, _flat(jp)


def _batch(cfg, B=2, S=80, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    return {"tokens": toks, "labels": labels}


def _to(batch, side):
    if side == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_amp_loss_and_grads_match_reference(amp_pair):
    """loss_fn and its gradients under amp="bf16" against the reference's
    jit(value_and_grad(loss_fn)), called outside the reference's sharding
    context (inside it XLA's CPU backend refuses the bf16 x bf16 -> f32
    dot).  Both sides round at the same places; the loss within 1e-3
    relative and every gradient at the bf16 gradient tier (atol 5e-2 / rtol
    5e-2) and within 2% of its tensor's largest entry: an operand that
    differs by f32 rounding can round to the neighbouring bf16 value."""
    jm, jp, tm, tp = amp_pair
    batch = _batch(jm.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    want = _flat(jgrads)
    for name, w in want.items():
        g = tgrads[name].detach()
        torch.testing.assert_close(g, w, atol=5e-2, rtol=5e-2, msg=name)
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 0.02 * scale + 1e-7, name


def test_amp_changes_the_numbers_and_routes_through_attention(amp_pair, monkeypatch):
    """Under amp, every layer's attention goes through ops.attention with the
    bf16 policy, and the loss differs from the f32 model's; with explicit
    positions (not 0..S-1) the plain attention runs, as in the reference."""
    _, _, tm, tp = amp_pair
    calls = []
    real = ops.attention

    def spy(*a, **kw):
        calls.append(kw["policy"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    batch = _to(_batch(tm.cfg), "torch")
    loss = tm.loss_fn(tp, batch)
    assert calls == [QuantPolicy("bf16")] * tm.cfg.n_layers
    f32 = tbuild(tm.cfg.replace(amp=""), device="cpu")
    assert float(f32.loss_fn(tp, batch)) != float(loss)
    B, S = batch["tokens"].shape
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    tm.forward(tp, batch["tokens"], positions=pos)
    assert len(calls) == tm.cfg.n_layers


def test_three_amp_train_steps_match_reference(amp_pair):
    """make_train_step under amp for three steps from the same weights on
    the same batches against the reference's jit(make_train_step), outside
    its sharding context.  Adam's eps is 1e-5 for the reason
    test_torch_train.py's three-step test gives; the losses within 1e-3
    relative and the weights at the bf16 gradient tier (atol 5e-2 / rtol
    5e-2) after three steps of lr 1e-2."""
    jm, jp, tm, tp = amp_pair
    cfg = jm.cfg
    kw = dict(weight_decay=0.01, eps=1e-5)
    jopt = JOptimizer.create("adamw", 1e-2, jm.p13n, jm.meta,
                             schedule=jsched.linear_decay(3, warmup_steps=1), **kw)
    topt = TOptimizer.create("adamw", 1e-2, tm.p13n, tm.meta,
                             schedule=tsched.linear_decay(3, warmup_steps=1), **kw)
    jstep = jax.jit(jmake_step(jm, jopt))
    tstep = tmake_step(tm, topt)
    pipe = tpipeline(cfg.vocab_size, 72, 2, seed=3)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for t in range(3):
        b = pipe.batch(t)
        jp, jstate, jm_ = jstep(jp, jstate, _to(b, "jax"))
        tp, tstate, tm_ = tstep(tp, tstate, _to(b, "torch"))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-3)
    want = _flat(jp)
    for name, w in want.items():
        torch.testing.assert_close(tp[name], w, atol=5e-2, rtol=5e-2, msg=name)


def _loop(amp, steps=10):
    cfg = tconfigs.get_smoke_config("mup-gpt").replace(dtype="float32", amp=amp)
    return ttrain.train_loop(cfg, steps=steps, hps=ttrain.HParams(lr=1e-2, sigma=1.0),
                             batch_size=4, seq_len=32, log_every=0, device="cpu")


def test_amp_loss_parity_with_f32():
    """The reference's acceptance bar for amp (tests/test_quant.py's
    test_amp_loss_parity, which cannot run at bf16 on the CPU inside its
    sharding context): the mean loss of the last 3 of 10 steps within 1% of
    the f32 run's, and the losses not equal to it (the policy is on)."""
    base = _loop("")["losses"]
    out = _loop("bf16")["losses"]
    want, got = float(np.mean(base[-3:])), float(np.mean(out[-3:]))
    assert abs(got - want) / want < 0.01, (got, want)
    assert out != base
    assert all(math.isfinite(x) for x in out) and out[-1] < out[0]


# ---------------------------------------------------------------------------
# dispatch on the CPU
# ---------------------------------------------------------------------------

def test_flash_kernels_on_cpu_raise_and_count_nothing():
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(1, 8, 2, 1, 16))
    lse = delta = torch.zeros(1, 2, 8)
    ops.reset_launch_counts()
    ops.attention(q, k, v, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, scale=0.25, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    int8 = QuantPolicy("int8")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v, policy=int8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, policy=int8)
    torch.testing.assert_close(     # the int8 plain version, on the CPU
        ops.attention(q, k, v, scale=0.25, policy=int8),
        ref.attention_policy_ref(q, k, v, scale=0.25, policy=int8), rtol=0, atol=0)
    counts = ops.launch_counts()
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_int8",
            "flash_bwd_dq_int8", "flash_bwd_dkv_int8"} <= set(counts)
    assert set(counts.values()) == {0}


def test_inactive_policy_is_the_f32_plain_version():
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_inputs(2, 24, 4, 2, 16))
    want = ops.attention(q, k, v, scale=0.25, window=8)
    got = ops.attention(q, k, v, scale=0.25, window=8, policy=QuantPolicy("none"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert policy_of(tconfigs.get_smoke_config("mup-gpt")) == QuantPolicy("none")
    assert policy_of(tconfigs.get_smoke_config("mup-gpt").replace(amp="bf16")).active
    with pytest.raises(ValueError, match="amp"):
        tconfigs.get_smoke_config("mup-gpt").replace(amp="fp8")
