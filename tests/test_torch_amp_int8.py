"""The port's int8 mixed-precision path (``--amp int8``) against the
reference: ``kernel_dot`` and ``quant_matmul`` in the int8 mode, the plain
versions of B5-B7 at the CUDA kernels' contract in the int8 mode, the model
and the train loop under ``amp="int8"``, on the same numpy inputs and
weights.

int8 arithmetic (the reference's ``repro/quant/core.py``): per-row absmax /
127 scales of the left operand and per-column ones of the right, over the
contraction axis, bytes rounded half to even and clipped to +-127, exact
integer sums, then ``acc * sa * sb`` in f32.  The port sums as a float64
matmul of the int8 values, exact at any k.

Tolerances.  ``kernel_dot`` and ``quant_matmul``: equal bytes and scales,
outputs within one f32 ulp (measured here: equal).  The plain versions at
the kernels' contract (``ref.flash_fwd_ref`` / ``flash_bwd_ref``, tiled as
the kernels tile, ``ref.FLASH_TILES``) against the reference's
interpret-mode kernels at ``block_q = block_k = 128``, the blocks its model
runs them at: an ulp of exp or tanh between torch and XLA can move a
quantized p or ds across a half step, so each output's max abs error is
held at the int8 tier against f32 (5e-2, docs/kernels.md) and its mean at
3e-5 (measured here: o within 3e-6 in every case, no p byte moved; dq, dk,
dv up to 1.3e-2 where a ds byte moved, means up to 1.4e-5).  The same plain
versions tiled 64 wide, whose scales run over other tiles, miss that mean
by more than 10x (measured: 3.9e-4 and more).  The model, a first step:
the loss within 1e-4 relative (measured 3.3e-6) and every gradient at the
bf16 gradient tier (atol 5e-2 / rtol 5e-2) and within 2% of its tensor's
largest entry (measured 0.34%); three train steps: losses within 1e-3
relative (measured 2.4e-4: a byte that moves after an update moves the
next loss) and weights at atol 5e-2 / rtol 5e-2 (measured 5e-3).
"""
import importlib.util
import math
from pathlib import Path

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
from repro.quant.core import kernel_dot as jkernel_dot  # noqa: E402
from repro.quant.core import quant_matmul as jquant_matmul  # noqa: E402
from repro.quant.core import quantize_int8 as jquantize  # noqa: E402
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
from repro_torch.quant import QuantPolicy, kernel_dot, quant_matmul, quantize_int8  # noqa: E402

INT8 = QuantPolicy("int8")
JINT8 = JPolicy("int8")
INT8_MAX_ERR = 5e-2     # the int8 tier against f32
INT8_MEAN_ERR = 3e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _within_one_ulp(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 1.0, (what, float(ulps.max()))


# ---------------------------------------------------------------------------
# kernel_dot and quant_matmul
# ---------------------------------------------------------------------------

# (a shape, b shape): 2-D, batched (the reference's vmap of its 2-D dot), and
# a contraction of 4,096 terms
DOT_SHAPES = {"2-D": ((6, 40), (40, 24)), "batched": ((3, 4, 16, 40), (3, 4, 40, 24)),
              "k 4096": ((16, 4096), (4096, 8))}


@pytest.mark.parametrize("case", sorted(DOT_SHAPES))
def test_int8_kernel_dot_matches_reference(case):
    """The same bytes and scales as the reference's quantize_int8 (a per
    row, b per column), and the product within one f32 ulp of its
    kernel_dot (vmapped over the batch axes)."""
    rng = np.random.default_rng(4)
    ash, bsh = DOT_SHAPES[case]
    a = rng.standard_normal(ash).astype(np.float32)
    b = rng.standard_normal(bsh).astype(np.float32)
    dot = lambda x, y: jkernel_dot(x, y, JINT8)      # noqa: E731
    for _ in range(len(ash) - 2):
        dot = jax.vmap(dot)
    want = np.asarray(dot(jnp.asarray(a), jnp.asarray(b)))
    got = kernel_dot(torch.from_numpy(a), torch.from_numpy(b), INT8)
    assert got.dtype == torch.float32
    _within_one_ulp(got.numpy(), want, case)
    for x, axis in ((a, -1), (b, -2)):
        tq, ts = quantize_int8(torch.from_numpy(x), axis=axis)
        jq, js = jquantize(jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_accumulation_is_exact_at_k_4096():
    """Sums of 4,096 int8 products of one sign pass 2^24, where an f32
    accumulation rounds; kernel_dot equals the exact int64 sum rescaled
    (acc * sa * sb in f32), and an f32 matmul of the same bytes does not."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.9, 1.0, (8, 4096)).astype(np.float32)
    b = rng.uniform(0.9, 1.0, (4096, 8)).astype(np.float32)
    qa, sa = quantize_int8(torch.from_numpy(a), axis=-1)
    qb, sb = quantize_int8(torch.from_numpy(b), axis=-2)
    exact = qa.numpy().astype(np.int64) @ qb.numpy().astype(np.int64)
    assert exact.max() > 2**24
    want = exact.astype(np.float32) * sa.numpy() * sb.numpy()
    got = kernel_dot(torch.from_numpy(a), torch.from_numpy(b), INT8).numpy()
    np.testing.assert_array_equal(got, want)
    f32_acc = (qa.float() @ qb.float()).numpy().astype(np.int64)
    assert (f32_acc != exact).any()


# (x shape, w shape): 2-D, leading batch dims collapsed to rows, and a dW
# = xᵀ·g that contracts 4,096 rows
MATMUL_SHAPES = {"2-D": ((6, 40), (40, 24)), "batch rows": ((2, 5, 64), (64, 48)),
                 "dW over 4096 rows": ((4096, 16), (16, 8))}


@pytest.mark.parametrize("case", sorted(MATMUL_SHAPES))
def test_int8_quant_matmul_matches_reference(case):
    """Forward and both straight-through gradients (each under the int8
    policy) within one f32 ulp of the reference's jax.vjp."""
    rng = np.random.default_rng(6)
    xs, ws = MATMUL_SHAPES[case]
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    g = rng.standard_normal(xs[:-1] + ws[-1:]).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b: jquant_matmul(a, b, JINT8),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = quant_matmul(tx, tw, INT8)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    for name, t, j in (("out", out.detach(), jout), ("dx", dx, jdx), ("dw", dw, jdw)):
        _within_one_ulp(t.numpy(), np.asarray(j), f"{case} {name}")


# ---------------------------------------------------------------------------
# the plain versions at the kernels' contract, int8 mode
# ---------------------------------------------------------------------------

# B, S, H, K, d, window, softcap, scale
INT8_CASES = {
    "causal, GQA 4/2": (1, 256, 4, 2, 64, 0, 0.0, 0.125),
    "window 48": (1, 256, 4, 2, 64, 48, 0.0, 0.125),
    "softcap 20": (1, 256, 4, 2, 64, 0, 20.0, 0.5),
    # the reference's blocks shrink to 80; the port's 128 tile pads with zeros
    "S 80": (2, 80, 4, 2, 32, 0, 0.0, 0.125),
    "d_head 128": (1, 256, 2, 2, 128, 0, 0.0, 0.125),
    # gemma2's heads of 256 (the kernels' DP 256), its softcap 50, a window
    "d_head 256, window 48, softcap 50": (1, 256, 4, 2, 256, 48, 50.0, 0.0625),
}
OUTS = ("o", "dq", "dk", "dv")


def _attn_inputs(B, S, H, K, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, d), (B, S, K, d), (B, S, K, d), (B, S, H, d))]


@pytest.fixture(scope="module")
def reference_kernel():
    """(inputs, (o, dq, dk, dv)) of the reference's interpret-mode kernels
    at 128 x 128 blocks under the int8 policy, by case, computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            B, S, H, K, d, window, softcap, scale = INT8_CASES[case]
            arrays = _attn_inputs(B, S, H, K, d)
            q, k, v, do = (jnp.asarray(a) for a in arrays)

            def f(q, k, v):
                return jops.attention(q, k, v, scale=scale, causal=True, window=window,
                                      softcap=softcap, block_q=128, block_k=128,
                                      impl="interpret", policy=JINT8)

            o, vjp = jax.vjp(f, q, k, v)
            cache[case] = arrays, [np.asarray(o)] + [np.asarray(g) for g in vjp(do)]
        return cache[case]

    return get


def _kernel_contract(arrays, *, scale, window, softcap):
    """(o, dq, dk, dv) composed as ops.attention composes B5-B7 (the scale
    folded into q, delta = rowsum(do * o) between forward and backward) from
    the int8 plain versions."""
    q, k, v, do = (torch.from_numpy(a.copy()) for a in arrays)
    kw = dict(causal=True, window=window, softcap=softcap, policy=INT8)
    o, lse = ref.flash_fwd_ref(q * scale, k, v, **kw)
    delta = (do * o).sum(-1).transpose(1, 2)
    dq, dk, dv = ref.flash_bwd_ref(q * scale, k, v, do, lse, delta, **kw)
    return [o.numpy(), (dq * scale).numpy(), dk.numpy(), dv.numpy()]


def _errors(case, reference_kernel):
    _, _, _, _, _, window, softcap, scale = INT8_CASES[case]
    arrays, want = reference_kernel(case)
    got = _kernel_contract(arrays, scale=scale, window=window, softcap=softcap)
    return {n: (float(np.abs(g - w).max()), float(np.abs(g - w).mean()))
            for n, g, w in zip(OUTS, got, want)}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_plain_versions_match_reference_kernel(reference_kernel, case):
    """Each output's max abs error within the int8 tier, its mean within
    INT8_MEAN_ERR."""
    for name, (mx, mean) in _errors(case, reference_kernel).items():
        assert mx <= INT8_MAX_ERR and mean <= INT8_MEAN_ERR, (case, name, mx, mean)


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_control_with_64_wide_tiles_fails(reference_kernel, case, monkeypatch):
    """The plain versions with 64-wide int8 tiles (B5's and B6's keys, B7's
    queries) compute another function: every output's mean error is more
    than 10x INT8_MEAN_ERR."""
    for kernel in ref.FLASH_TILES:
        monkeypatch.setitem(ref.FLASH_TILES[kernel], "int8", (64, 64))
    for name, (_, mean) in _errors(case, reference_kernel).items():
        assert mean > 10 * INT8_MEAN_ERR, (case, name, mean)


def test_int8_tiles_carry_the_scales():
    """The tiles of the int8 mode: 128 keys for B5 and B6, 128 queries for
    B7, the reference model's block along every axis that carries a
    scale."""
    assert ref.flash_tile("fwd", INT8)[1] == 128
    assert ref.flash_tile("dq", INT8)[1] == 128
    assert ref.flash_tile("dkv", INT8)[0] == 128
    assert ref.flash_tile("fwd", None) == ref.flash_tile("fwd", QuantPolicy("bf16"))


# ---------------------------------------------------------------------------
# the model and the train loop under amp="int8"
# ---------------------------------------------------------------------------

INT8_CONFIGS = {
    "mup-gpt-smoke": lambda m: m.get_smoke_config("mup-gpt").replace(
        dtype="float32", zero_init_query=False, amp="int8"),
    "mup-gpt@0.125x": lambda m: m.get_config("mup-gpt").replace(
        n_layers=2, dtype="float32", zero_init_query=False, amp="int8").scaled(0.125),
}


def _flat(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module", params=sorted(INT8_CONFIGS))
def int8_pair(request):
    make = INT8_CONFIGS[request.param]
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


def test_int8_loss_and_grads_match_reference(int8_pair):
    """loss_fn and its gradients under amp="int8" against the reference's
    jit(value_and_grad(loss_fn)): attention (the plain int8 attention on the
    CPU, both sides) and the readout quantize at the same places."""
    jm, jp, tm, tp = int8_pair
    batch = _batch(jm.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    for name, w in _flat(jgrads).items():
        g = tgrads[name].detach()
        torch.testing.assert_close(g, w, atol=5e-2, rtol=5e-2, msg=name)
        assert (g - w).abs().max().item() <= 0.02 * w.abs().max().item() + 1e-7, name


def test_three_int8_train_steps_match_reference(int8_pair):
    """make_train_step under amp="int8" for three steps from the same weights
    on the same batches against the reference's jit(make_train_step), Adam
    at eps 1e-5 as in test_torch_amp.py."""
    jm, jp, tm, tp = int8_pair
    kw = dict(weight_decay=0.01, eps=1e-5)
    jopt = JOptimizer.create("adamw", 1e-2, jm.p13n, jm.meta,
                             schedule=jsched.linear_decay(3, warmup_steps=1), **kw)
    topt = TOptimizer.create("adamw", 1e-2, tm.p13n, tm.meta,
                             schedule=tsched.linear_decay(3, warmup_steps=1), **kw)
    jstep = jax.jit(jmake_step(jm, jopt))
    tstep = tmake_step(tm, topt)
    pipe = tpipeline(jm.cfg.vocab_size, 72, 2, seed=3)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for t in range(3):
        b = pipe.batch(t)
        jp, jstate, jm_ = jstep(jp, jstate, _to(b, "jax"))
        tp, tstate, tm_ = tstep(tp, tstate, _to(b, "torch"))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-3)
    for name, w in _flat(jp).items():
        torch.testing.assert_close(tp[name], w, atol=5e-2, rtol=5e-2, msg=name)


def _loop(amp, steps=10):
    cfg = tconfigs.get_smoke_config("mup-gpt").replace(dtype="float32", amp=amp)
    return ttrain.train_loop(cfg, steps=steps, hps=ttrain.HParams(lr=1e-2, sigma=1.0),
                             batch_size=4, seq_len=32, log_every=0, device="cpu")


def test_int8_loss_parity_with_f32():
    """The reference's acceptance bar for amp (tests/test_quant.py's
    test_amp_loss_parity[int8]): the mean loss of the last 3 of 10 steps
    within 1% of the f32 run's, and the losses not equal to it."""
    base = _loop("")["losses"]
    out = _loop("int8")["losses"]
    want, got = float(np.mean(base[-3:])), float(np.mean(out[-3:]))
    assert abs(got - want) / want < 0.01, (got, want)
    assert out != base
    assert all(math.isfinite(x) for x in out) and out[-1] < out[0]


def test_int8_policy_routes_attention_and_readout(monkeypatch):
    """Under amp="int8" every layer's attention goes through ops.attention
    with the int8 policy, and the readout through quant_matmul with it."""
    cfg = tconfigs.get_smoke_config("mup-gpt").replace(dtype="float32", amp="int8")
    model = tbuild(cfg, device="cpu")
    params = model.init(seed=0)
    seen = []
    real_attn, real_mm = ops.attention, quant_matmul

    def spy_attn(*a, **kw):
        seen.append(("attention", kw["policy"]))
        return real_attn(*a, **kw)

    def spy_mm(x, w, policy=None):
        seen.append(("readout", policy))
        return real_mm(x, w, policy)

    from repro_torch.models import model as tmodel
    monkeypatch.setattr(ops, "attention", spy_attn)
    monkeypatch.setattr(tmodel, "quant_matmul", spy_mm)
    model.loss_fn(params, _to(_batch(cfg, S=16), "torch"))
    assert seen == [("attention", INT8)] * cfg.n_layers + [("readout", INT8)]


# ---------------------------------------------------------------------------
# on the card: B5-B7 in the int8 mode against their plain versions
# ---------------------------------------------------------------------------

# B, S, H, K, d, window, softcap, storage dtype
GPU_CASES = [
    (2, 256, 4, 2, 64, 0, 0.0, torch.float32),
    (2, 200, 9, 3, 64, 48, 0.0, torch.float32),     # GQA, window, ragged S
    (1, 190, 4, 4, 128, 0, 20.0, torch.float32),    # softcap, d 128, ragged S
    (1, 192, 6, 2, 32, 0, 0.0, torch.bfloat16),
    (1, 256, 8, 4, 256, 48, 50.0, torch.float32),   # gemma2's heads: DP 256
]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,d,window,softcap,dt", GPU_CASES)
def test_int8_flash_kernels_match_plain_on_card(B, S, H, K, d, window, softcap, dt):
    """B5-B7 in the int8 mode, one launch each, against their plain versions
    by chip_smoke.py's check (lse at f32, o and dq/dk/dv max within the
    int8 tier and mean within FLASH_MEAN_TOL), which the plain versions
    tiled 64 wide must fail; dk/dv the same bits when repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt) for _ in range(2))
    k, v = (torch.randn(B, S, K, d, device="cuda", generator=gen).to(dt) for _ in range(2))
    qs = (q.float() * (0.5 if softcap else 0.125)).to(dt)
    kw = dict(causal=True, window=window, softcap=softcap, policy=INT8)
    n0 = ops.launch_counts()
    got, want, delta = cs.flash_pair(fa, ref, qs, k, v, do, **kw)
    n1 = ops.launch_counts()
    assert [n1[n] - n0[n] for n in ("flash_fwd_int8", "flash_bwd_dq_int8",
                                    "flash_bwd_dkv_int8")] == [1, 1, 1]
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=1e-5)
    pairs = list(zip(OUTS, got[:1] + got[2:], want[:1] + want[2:]))
    for name, g, w in pairs:
        assert cs.rounds_like(name, cs.rounded_err(g, w), cs.INT8_MAX_TOL), name
    with cs.int8_tiles(ref, 64):
        wrong = (ref.flash_fwd_ref(qs, k, v, **kw)[0],
                 *ref.flash_bwd_ref(qs, k, v, do, got[1], delta, **kw))
    for (name, g, _), w in zip(pairs, wrong):
        assert not cs.rounds_like(name, cs.rounded_err(g, w), cs.INT8_MAX_TOL), name
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, got[1], delta, **kw)
    assert torch.equal(dk, got[3]) and torch.equal(dv, got[4])
