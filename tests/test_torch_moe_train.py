"""MoE training in the port against the reference: mixtral-8x22b's smoke
(every layer ``local_moe``, top-2) and llama4-scout's (three ``local_moe``
layers and one global ``moe`` layer, top-1), both with untied embeddings.

Weights come from the reference's init and move over by
``convert.params_from_numpy``; batches are drawn with numpy from fixed
seeds.  With ``zero_init_readout=False`` and ``zero_init_query=False``:
under µP a zero readout makes every gradient but the readout's exactly 0
at step 0, and a zero query makes attention uniform.

- The batched HP sweep (``core.tuning.train_proxy_batched``) on both
  smokes: under ``torch.func.vmap`` models/moe.py's dispatch and combine
  must run out of place (an in-place ``scatter_`` / ``index_add_`` on an
  unbatched tensor is refused there).  Against the reference's engine on
  its own init and against the port's serial loop at SWEEP_RTOL (2e-3, the
  reference's), in f32 and under ``amp="bf16"`` / ``"int8"``;
  ``coord_check_batched`` on mixtral's smoke family against the
  reference's records and the port's one-lr runs (tests/test_torch_sweep.py's
  tolerances); ``moe_ffn`` under vmap bit-equal to separate calls.
- ``loss_fn`` and every gradient (router, ``wi``, ``wo``, ``unembed``,
  ``embed``, attention, gains) against the reference's
  ``jax.value_and_grad`` in f32, bf16 and int8, at the smokes' own width
  and at ``.scaled(2)``, where the µP multipliers are not 1
  (tests/test_torch_gemma2.py's TRAIN_BARS); under a router that sends
  every token to one expert first (slots dropped past capacity) too, with
  the dropped slots equal on both sides, their gates' gradients and their
  expert outputs exactly 0; three AdamW steps; amp's routing of attention
  (ops.attention once a layer, windowed on ``local_moe`` layers only) and
  no expert product through ``quant_matmul``; ``collect_stats`` on a train
  step.
- The train CLI on the CPU (f32, bf16, int8), and its memory refusal on a
  card (``train_state_bytes``, a stood-in card).
"""
import dataclasses
import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import coord_check as jcoord  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.core.init import init_params as jinit_params  # noqa: E402
from repro.core.parametrization import resolve as jresolve  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.optimizer import Optimizer as JOptimizer  # noqa: E402
from repro_torch import quant as tquant  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import coord_check as tcoord  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.hpspace import mup_space  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.core.parametrization import resolve as tresolve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_step  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import activation as t_act  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim.optimizer import Optimizer as TOptimizer  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402

MOE_ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
OVER = dict(dtype="float32", zero_init_query=False, zero_init_readout=False)
SWEEP_RTOL = 2e-3               # the reference's batched-vs-serial tolerance
CC_RTOL, CC_ATOL = 5e-3, 1e-6   # tests/test_torch_coord_check.py's
ACT_TOL = dict(atol=1e-4, rtol=1e-4)   # tests/test_torch_obs.py's, for the stats
KW = dict(steps=6, batch_size=4, seq_len=32)
CANDIDATES = [dict(lr=5e-3), dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
              dict(lr=2e-2, sigma=2.0, alpha_attn=2.0, alpha_embed=0.5)]
# (loss tolerance, gradient tolerance, largest error as a share of the
# tensor's largest entry): tests/test_torch_gemma2.py's TRAIN_BARS
TRAIN_BARS = {
    "f32": (dict(atol=2e-5, rtol=1e-6), dict(atol=2e-4, rtol=1e-3), None),
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


def _pair(arch, width=1.0, amp="", **over):
    """(reference model, its params, port model, the same params) of
    ``arch``'s smoke at ``width`` times its widths (its own µP base)."""
    over = dict(OVER, amp=amp, **over)
    jcfg, tcfg = j_smoke(arch, **over), t_smoke(arch, **over)
    if width != 1.0:
        jcfg, tcfg = jcfg.scaled(width), tcfg.scaled(width)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tbuild(tcfg, device="cpu"), _to_torch(jp)


def _batch(V, B=2, S=64, seed=0):
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


def _grads_close(tgrads, jgrads, grad_tol, share):
    want = _to_torch(jgrads)
    assert sorted(tgrads) == sorted(want)
    for name, w in want.items():
        g = tgrads[name].detach()
        torch.testing.assert_close(g, w, **grad_tol, msg=name)
        if share is not None:
            assert (g - w).abs().max().item() <= share * w.abs().max().item() + 1e-7, name


# ---------------------------------------------------------------------------
# the batched sweep and coord check over MoE configs
# ---------------------------------------------------------------------------

def _candidates():
    space = mup_space()
    return [space.hparams(**c) for c in CANDIDATES]


def _reference_init(jcfg, cands):
    """The reference engine's init (tests/test_torch_sweep.py's): init_params
    at candidate_rngs(0, n)[i] with candidate i's sigma, stacked."""
    model = jbuild(jcfg.replace(dtype="float32"))
    stacked = jax.vmap(lambda r, s: jinit_params(r, model.meta, model.p13n, sigma=s))(
        jtuning.candidate_rngs(0, len(cands)),
        jnp.asarray([h.sigma for h in cands], jnp.float32))
    return flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                        lambda x: isinstance(x, np.ndarray))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_batched_sweep_matches_reference_and_serial(arch):
    """train_proxy_batched on the reference's init against the reference's
    engine and against the port's serial loop (under the in-place scatter_
    the port raised 'vmap: aten::scatter_ ... is not possible')."""
    cands = _candidates()
    init = params_from_numpy(_reference_init(j_smoke(arch), cands), device="cpu")
    got = ttuning.train_proxy_batched(t_smoke(arch), cands, device="cpu",
                                      init_fn=lambda gens, hp: init, **KW)
    want = jtuning.train_proxy_batched(j_smoke(arch), cands, **KW)
    assert got.active.all() and got.steps_run == KW["steps"]
    np.testing.assert_allclose(got.curves, want.curves, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(got.losses, want.losses, rtol=SWEEP_RTOL)
    assert got.best_index == want.best_index
    ser = ttuning.train_proxy_serial(t_smoke(arch), cands, device="cpu",
                                     init_fn=lambda gens, hp: init, **KW)
    np.testing.assert_allclose(ser.curves, want.curves, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(got.curves, ser.curves, rtol=SWEEP_RTOL)


@pytest.mark.parametrize("amp", ["bf16", "int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_batched_sweep_under_amp_matches_serial(arch, amp):
    cfg = t_smoke(arch).replace(amp=amp)
    cands = _candidates()
    bat = ttuning.train_proxy_batched(cfg, cands, device="cpu", **KW)
    ser = ttuning.train_proxy_serial(cfg, cands, device="cpu", **KW)
    assert bat.active.all() and np.isfinite(bat.curves).all()
    np.testing.assert_allclose(bat.curves, ser.curves, rtol=SWEEP_RTOL)
    assert bat.best_index == ser.best_index


CC_WIDTHS, CC_LRS, CC_STEPS = (1.0, 2.0), (1e-2, 1e-1), 2


def _cc_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for w in want:
        for t, (g, r) in enumerate(zip(got[w], want[w])):
            assert sorted(g) == sorted(r), (what, w, t)
            for k in r:
                np.testing.assert_allclose(np.asarray(g[k]), np.asarray(r[k]), rtol=CC_RTOL,
                                           atol=CC_ATOL, err_msg=f"{what} w={w} t={t} {k}")


def test_coord_check_batched_on_the_mixtral_family():
    """Two widths x two lrs, batched over the lrs: against the reference's
    coord_check_batched records and against the port's one-lr runs."""
    jbase = j_smoke("mixtral-8x22b", **OVER)
    tbase = t_smoke("mixtral-8x22b", **OVER)

    def jmake(i):
        model = jbuild(jbase.scaled(CC_WIDTHS[i]))
        return (model.init(jax.random.PRNGKey(0)), model.meta,
                lambda p, b: model.loss_fn(p, b, collect_acts=True))

    def tmake(i):
        params = _to_torch(jbuild(jbase.scaled(CC_WIDTHS[i])).init(jax.random.PRNGKey(0)))
        model = tbuild(tbase.scaled(CC_WIDTHS[i]), device="cpu")
        return params, model.meta, lambda p, b: model.loss_fn(p, b, collect_acts=True)

    pipe = jpipeline(jbase.vocab_size, 32, 4, seed=0)
    raw = [pipe.batch(t) for t in range(CC_STEPS)]
    widths = list(range(len(CC_WIDTHS)))
    got = tcoord.coord_check_batched(tmake, widths, [_to(b, "torch") for b in raw],
                                     tresolve("mup"), lrs=CC_LRS)
    for i, lr in enumerate(CC_LRS):
        one = tcoord.coord_check(tmake, widths, [_to(b, "torch") for b in raw],
                                 tresolve("mup"), lr=lr)
        _cc_close(got.candidate_view(i).records, one.records, f"lr {lr}")
    want = jcoord.coord_check_batched(jmake, widths, [_to(b, "jax") for b in raw],
                                      jresolve("mup"), lrs=CC_LRS)
    _cc_close(got.records, want.records, "reference")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_under_vmap_equals_separate_calls_bit_for_bit(arch):
    """Three stacked parameter sets through one vmapped moe_ffn: each slice
    equals its own call bit for bit (the out-of-place scatter and index_add
    keep the in-place versions' bits)."""
    cfg = t_smoke(arch, **OVER)
    meta = tmoe.moe_meta(cfg, "moe")
    rng = np.random.default_rng(7)
    sets = [{n: torch.from_numpy((0.3 * rng.standard_normal(m.infshape.shape))
                                 .astype(np.float32)) for n, m in meta.items()}
            for _ in range(3)]
    stacked = {n: torch.stack([s[n] for s in sets]) for n in meta}
    x = torch.from_numpy(rng.standard_normal((2, 33, cfg.d_model)).astype(np.float32))
    act = t_act(cfg.act.replace("_glu", ""))
    got = torch.func.vmap(lambda p: tmoe.moe_ffn(cfg, p, meta, x, "mup", act))(stacked)
    for i, s in enumerate(sets):
        assert torch.equal(got[i], tmoe.moe_ffn(cfg, s, meta, x, "mup", act)), i
    # and with the input batched too
    xs = torch.stack([x, 2 * x, -x])
    got = torch.func.vmap(lambda p, xx: tmoe.moe_ffn(cfg, p, meta, xx, "mup", act))(stacked, xs)
    for i, s in enumerate(sets):
        assert torch.equal(got[i], tmoe.moe_ffn(cfg, s, meta, xs[i], "mup", act)), i


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1.0, 2.0], ids=["width1", "scaled2"])
@pytest.mark.parametrize("mode", sorted(TRAIN_BARS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch, mode, width):
    """loss_fn and every gradient against the reference's
    jit(value_and_grad(loss_fn)); under amp both sides' attention takes
    the flash kernels' path (their plain versions here) and the readout
    rounds or quantizes."""
    jm, jp, tm, tp = _pair(arch, width, amp="" if mode == "f32" else mode)
    batch = _batch(jm.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    loss_tol, grad_tol, share = TRAIN_BARS[mode]
    np.testing.assert_allclose(float(tloss), float(jloss), **loss_tol)
    _grads_close(tgrads, jgrads, grad_tol, share)
    # every MoE tensor and the readout have a gradient that is not 0
    for name, g in tgrads.items():
        if name.endswith((".router", ".wi", ".wo")) or name == "unembed":
            assert g.abs().max().item() > 0, name


def _one_expert_first(params, cfg):
    """The reference's weights with every token sent to expert 0 first:
    the embedding's coordinate 0 set to 10 (after the norms the largest
    coordinate of every row, of one sign) and the router's row 0 to 8 for
    expert 0 and 0 for the rest."""
    p = dict(params)
    p["embed"] = params["embed"].at[:, 0].set(10.0)
    for name in [n for n in p["groups"]]:
        block = dict(p["groups"][name])
        mlp = dict(block["mlp"])
        mlp["router"] = mlp["router"].at[:, 0, :].set(0.0).at[:, 0, 0].set(8.0)
        block["mlp"] = mlp
        p["groups"] = dict(p["groups"], **{name: block})
    return p


def test_dropped_slots_match_the_reference():
    """mixtral's smoke at S 64 with expert 0 every token's first choice:
    capacity 40 for 64 first-choice slots, so the first choices of tokens
    40-63 are dropped.  Both sides choose and drop the same slots; a
    dropped slot's gate has an exactly zero gradient and its token gets
    exactly nothing from that expert; loss and gradients still match the
    reference."""
    jm, jp, tm, _ = _pair("mixtral-8x22b")
    jp = _one_expert_first(jp, jm.cfg)
    tp = _to_torch(jp)
    cfg = tm.cfg
    S, E, k = 64, cfg.n_experts, cfg.top_k
    C = tmoe._capacity(cfg, S)
    assert C == 40
    batch = _batch(cfg.vocab_size, S=S, seed=3)

    # the port's routing, gates kept for their gradients, and each layer's
    # expert outputs (the combine's input) read through moe_ffn's matmul
    seen, real = [], tmoe.route

    def route(*a, **kw):
        logits, gate, idx = real(*a, **kw)
        gate.retain_grad()
        seen.append((logits, gate, idx))
        return logits, gate, idx

    tmoe.route = route
    try:
        leaves = {n: v.detach().requires_grad_(True) for n, v in tp.items()}
        tloss = tm.loss_fn(leaves, _to(batch, "torch"))
        tloss.backward()
    finally:
        tmoe.route = real
    assert len(seen) == cfg.n_layers
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _to(batch, "jax"))
    np.testing.assert_allclose(float(tloss), float(jloss), **TRAIN_BARS["f32"][0])
    _grads_close({n: v.grad for n, v in leaves.items()}, jgrads, TRAIN_BARS["f32"][1], None)

    for layer, (logits, gate, idx) in enumerate(seen):
        assert (idx[..., 0] == 0).all(), layer
        # the reference's choices on the same router logits: the same
        _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.detach().numpy()), -1), k)
        np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
        # the slots the port's dispatch table keeps, against each expert's
        # first C slots in token-major order, counted here
        d_idx = tmoe.dispatch(idx, E, C)                       # (B, E, C)
        kept = torch.zeros(idx.shape[0], S * k, dtype=torch.bool)
        want = np.zeros((idx.shape[0], S * k), bool)
        for b in range(idx.shape[0]):
            kept[b, d_idx[b][d_idx[b] < S * k]] = True
            filled = [0] * E
            for t, e in enumerate(idx[b].reshape(-1).tolist()):
                want[b, t] = filled[e] < C
                filled[e] += 1
        np.testing.assert_array_equal(kept.numpy(), want)
        kept = kept.reshape(idx.shape)
        # expert 0's first 40 slots kept, its other 24 dropped
        assert kept[:, :C, 0].all() and not kept[:, C:, 0].any()
        assert (gate.grad[~kept] == 0).all() and (gate.grad[kept] != 0).any(), layer

    # the same slots through the reference's moe_ffn: a probe whose experts
    # write each kept slot's gate into column e (a dropped one reads 0)
    d, f = cfg.d_model, cfg.d_ff
    wi = np.zeros((E, d, 2 * f), np.float32)
    wo = np.zeros((E, f, d), np.float32)
    for e in range(E):
        wi[e, 0, f + e] = 1.0
        wo[e, e, e] = 1.0
    router = np.zeros((d, E), np.float32)
    router[0, 0] = 8.0
    router[1:] = 0.1 * np.random.default_rng(5).standard_normal((d - 1, E)).astype(np.float32)
    x = np.random.default_rng(6).standard_normal((2, S, d)).astype(np.float32)
    x[..., 0] = 1.0
    probe = dict(router=router, wi=wi, wo=wo)
    jcfg = jm.cfg
    jout = np.asarray(jax.jit(lambda p, xx: jmoe.moe_ffn(
        jcfg, p, jmoe.moe_meta(jcfg, "moe"), xx, "mup", jnp.ones_like))(
        {n: jnp.asarray(a) for n, a in probe.items()}, jnp.asarray(x)))
    tout = tmoe.moe_ffn(cfg, {n: torch.from_numpy(a) for n, a in probe.items()},
                        tmoe.moe_meta(cfg, "moe"), torch.from_numpy(x), "mup",
                        torch.ones_like).numpy()
    np.testing.assert_array_equal(tout[..., :E] != 0, jout[..., :E] != 0)
    np.testing.assert_allclose(tout, jout, atol=1e-6, rtol=0)
    # expert 0 serves exactly the first 40 tokens of each sequence; the
    # others' expert-0 output is exactly 0
    assert (tout[:, :C, 0] != 0).all() and (tout[:, C:, 0] == 0).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_three_adamw_steps_match_reference(arch):
    """make_train_step (AdamW, linear schedule, clipping, weight decay) for
    three steps at .scaled(2) from the same weights on the same batches
    (tests/test_torch_gemma2.py's bars: Adam's eps 1e-5, losses and
    gradient norms within 1e-4 relative, weights at atol 2e-4 / rtol
    1e-3)."""
    jm, jp, tm, tp = _pair(arch, 2.0)
    kw = dict(weight_decay=0.01, eps=1e-5)
    jopt = JOptimizer.create("adamw", 1e-2, jm.p13n, jm.meta,
                             schedule=jsched.linear_decay(3, warmup_steps=1), **kw)
    topt = TOptimizer.create("adamw", 1e-2, tm.p13n, tm.meta,
                             schedule=tsched.linear_decay(3, warmup_steps=1), **kw)
    jstep = jax.jit(jmake_step(jm, jopt))
    tstep = tmake_step(tm, topt)
    pipe = jpipeline(jm.cfg.vocab_size, 32, 2, seed=3)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for t in range(3):
        b = pipe.batch(t)
        jp, jstate, jmet = jstep(jp, jstate, _to(b, "jax"))
        tp, tstate, tmet = tstep(tp, tstate, _to(b, "torch"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)
    want = _to_torch(jp)
    assert sorted(tp) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(tp[name].detach().numpy(), w.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("amp", ["bf16", "int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_amp_routes_attention_and_keeps_the_experts_f32(arch, amp, monkeypatch):
    """Under amp each layer's attention goes through ops.attention with the
    policy, local_moe layers with their window and llama4's moe layer with
    none; the only quant_matmul is the readout's (the expert products stay
    f32 matmuls, as the reference computes them outside the policy)."""
    _, _, tm, tp = _pair(arch, amp=amp)
    calls, mm = [], []
    real_attn, real_qmm = ops.attention, tquant.core._quant_matmul_apply

    def spy(*a, **kw):
        calls.append((kw["window"], kw["policy"]))
        return real_attn(*a, **kw)

    def qspy(x, w, policy):
        mm.append(tuple(w.shape))
        return real_qmm(x, w, policy)

    monkeypatch.setattr(ops, "attention", spy)
    monkeypatch.setattr(tquant.core, "_quant_matmul_apply", qspy)
    cfg = tm.cfg
    tm.loss_fn(tp, _to(_batch(cfg.vocab_size, S=32), "torch"))
    kinds = list(cfg.pattern) * cfg.n_groups
    assert calls == [(cfg.window_size if k == "local_moe" else 0, QuantPolicy(amp))
                     for k in kinds]
    # the plain flash path's tile products (4-D operands) and the readout
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert mm.count((d, cfg.vocab_size)) == 1
    assert not {(E, d, 2 * f), (E, f, d), (d, 2 * f), (f, d)} & set(mm)
    assert all(len(s) == 4 for s in mm if s != (d, cfg.vocab_size))


def test_collect_stats_on_a_moe_step_match_the_reference():
    jm, jp, tm, tp = _pair("mixtral-8x22b")
    batch = _batch(jm.cfg.vocab_size, S=32)
    jloss, jst = jm.loss_fn(jp, _to(batch, "jax"), collect_stats=True)
    tloss, tst = tm.loss_fn(tp, _to(batch, "torch"), collect_stats=True)
    assert set(tst) == set(jst) == {"embed", "block/0_local_moe", "final_norm", "logits"}
    for k in jst:
        assert tst[k].shape == tuple(jst[k].shape), k
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), err_msg=k, **ACT_TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TRAIN_BARS["f32"][0])
    assert torch.equal(tm.loss_fn(tp, _to(batch, "torch")), tloss)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", ["", "bf16", "int8"], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_trains_moe_on_the_cpu(arch, amp):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch-size", "2", "--seq-len", "16"] + (["--amp", amp] if amp else [])
    out = ttrain.main(argv)
    assert out["steps_run"] == 3 and all(math.isfinite(v) for v in out["losses"])


@pytest.mark.parametrize("arch,layers,gb", [
    ("mixtral-8x22b", 1, 46.5), ("mixtral-8x22b", 2, 86.6), ("mixtral-8x22b", 56, 2250.1),
    ("llama4-scout-17b-a16e", 4, 166.0), ("llama4-scout-17b-a16e", 48, 1627.7),
    ("gemma2-27b", 46, 435.6)])
def test_train_state_bytes(arch, layers, gb):
    """4x the f32 weights (weights, gradients, two AdamW moments), counted
    from the parameter metas: within 1e-4 of 16 bytes a parameter of the
    reference's param_count (which leaves out the norms' gains)."""
    assert j_config(arch).n_layers >= layers
    model = tbuild(t_config(arch, n_layers=layers), device="cpu")
    got = ttrain.train_state_bytes(model)
    assert got == 16 * sum(math.prod(m.infshape.shape) for m in model.flat_meta.values())
    assert got / 1e9 == pytest.approx(gb, abs=0.05)
    assert got == pytest.approx(16 * j_config(arch, n_layers=layers).param_count(), rel=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_train_cli_refuses_what_a_card_cannot_hold(arch, monkeypatch, capsys):
    """On a card (stood in for: the model reports a CUDA device, the card
    80 GB) the CLI refuses a config whose weights, gradients and moments
    do not fit, naming the multi-GPU slice; the smoke passes the check."""
    real = ttrain.build_model

    def on_a_card(cfg, device="cuda", impl="auto"):
        model = real(cfg, device="cpu", impl=impl)
        return types.SimpleNamespace(device=torch.device("cuda"), flat_meta=model.flat_meta)

    monkeypatch.setattr(ttrain, "build_model", on_a_card)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * 10**9))
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", arch, "--steps", "1"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP.md § A 5" in err and "gradients and two AdamW moments" in err

    def no_loop(*a, **kw):
        raise RuntimeError("past the check")

    monkeypatch.setattr(ttrain, "train_loop", no_loop)
    with pytest.raises(RuntimeError, match="past the check"):
        ttrain.main(["--arch", arch, "--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# chip_smoke.py's train-step routing checks, on hand-made routings
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_train_routing_and_held_gradients():
    """train_routing counts a flip at a near-tie and names its experts,
    refuses one past the tie limit, counts drops past capacity; hold_grads
    holds the expert slices a flip did not touch and prints the rest."""
    cs = _chip_smoke()
    cfg = t_smoke("mixtral-8x22b", n_layers=1)
    S, E, k = 64, cfg.n_experts, cfg.top_k
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((1, S, E)).astype(np.float32))
    idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    def drops(ids):
        filled, n = [0] * E, 0
        for e in ids.reshape(-1).tolist():
            n += filled[e] >= 40
            filled[e] += 1
        return n

    same = cs.train_routing("[t]", cfg, [(logits, idx)], [(logits, idx)])
    assert same["flips"] == [] and same["touched"] == {}
    assert same["dropped_slots"] == drops(idx) and same["slots"] == S * k
    # a tie between the 2nd and 3rd expert of token 5, flipped on one side
    tied = logits.clone()
    order = idx[0, 5].tolist()
    third = [e for e in torch.sort(logits[0, 5], descending=True).indices.tolist()
             if e not in order][0]
    tied[0, 5, third] = tied[0, 5, order[1]]
    flipped = idx.clone()
    flipped[0, 5, 1] = third
    out = cs.train_routing("[t]", cfg, [(tied, flipped)], [(tied, idx)])
    assert [f["row"] for f in out["flips"]] == [[0, 5]]
    assert out["touched"] == {0: sorted({*order, third})}
    with pytest.raises(AssertionError, match="margin"):
        cs.train_routing("[t]", cfg, [(logits, flipped)], [(logits, idx)])
    # every token to expert 0 first: C = 40, 24 first choices dropped
    first = idx.clone()
    first[..., 0] = 0
    first[..., 1] = torch.where(idx[..., 0] == 0, idx[..., 1], idx[..., 0])
    got = cs.train_routing("[t]", cfg, [(logits, first)], [(logits, first)])
    assert got["dropped_slots"] == drops(first) >= S - 40

    grads = {"groups.0_local_moe.mlp.wi": torch.ones(1, E, 3, 4),
             "groups.0_local_moe.attn.wq": torch.ones(3, 3)}
    moved = {n: g.clone() for n, g in grads.items()}
    moved["groups.0_local_moe.attn.wq"] += 1.0
    for e in out["touched"][0]:
        moved["groups.0_local_moe.mlp.wi"][0, e] += 1.0
    within = lambda g, w: bool(((g - w).abs() <= 1e-6).all())  # noqa: E731
    bad, names = cs.hold_grads("[t]", moved, grads, out["touched"], within)
    assert bad == {} and names == ["groups.0_local_moe.attn.wq"]
    untouched = [e for e in range(E) if e not in out["touched"][0]][0]
    moved["groups.0_local_moe.mlp.wi"][0, untouched] += 1.0
    bad, _ = cs.hold_grads("[t]", moved, grads, out["touched"], within)
    assert list(bad) == [f"groups.0_local_moe.mlp.wi[0, {untouched}]"]


@pytest.mark.parametrize("amp", ["bf16", "int8"])
def test_chip_smoke_plain_flash_by_kv_heads_keeps_the_bits(amp):
    """chip_smoke.py's plain flash versions over a few kv heads a call (its
    mixtral train phases' plain side) give the whole call's outputs and
    gradients bit for bit: every rounding and quantization group lies
    within a head."""
    cs = _chip_smoke()
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 200, 12, 32), (1, 200, 4, 32), (1, 200, 4, 32),
                             (1, 200, 12, 32)))
    kw = dict(scale=0.2, causal=True, window=64, softcap=0.0, policy=QuantPolicy(amp))
    runs = []
    for kv_heads in (0, 1, 2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = cs.plain_flash(ops, kv_heads)(*leaves, **kw)
        runs.append([o.detach(), *torch.autograd.grad(o, leaves, do)])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
