"""The port's MoE FFN (models/moe.py) against the reference's on the CPU.

The same inputs, drawn with numpy from fixed seeds, and the same weights
(the reference's ``init_params``, moved over by ``convert.params_from_numpy``)
go through ``repro.models.moe.moe_ffn`` and the port's: the outputs at the
f32 tier (atol 2e-5), the expert choices exactly, and the kept and dropped
slots exactly, read through a probe whose experts write each kept slot's
gate into its own column (so a dropped slot shows as a zero).  Cases: 2, 4
and 8 experts, top-1 and top-2, sequences of 1, 5, 8, 33 and 64 tokens,
capacity ample, 1.25 and at its floor (capacity factor 1e-6: 8 places an
expert).  Also the capacity formula at the engines' lengths, the Switch
load-balancing loss, the router's µP multiplier and ties between experts.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.init import init_params as j_init  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import activation as j_act  # noqa: E402
from repro.models.layers import apply_w as j_apply_w  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import activation as t_act  # noqa: E402

ATOL = 2e-5
D, FF, B = 16, 32, 2
CAPACITY = {"ample": None, "cf 1.25": 1.25, "floor": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(E, k, cf, d=D, f=FF):
    """The reference's MoE test fixture (tests/test_moe.py ``_setup``) on
    both sides: the mixtral smoke at width d with E experts, top-k and
    capacity factor cf (None: E, which makes C = S k, every slot kept)."""
    over = dict(d_model=d, d_ff=f, n_experts=E, top_k=k,
                capacity_factor=float(E) if cf is None else cf, base_d_model=d, base_d_ff=f)
    return j_smoke("mixtral-8x22b").replace(**over), t_smoke("mixtral-8x22b").replace(**over)


@functools.lru_cache(maxsize=None)
def _init(jcfg, seed):
    jp = j_init(jax.random.PRNGKey(seed), jmoe.moe_meta(jcfg, "moe"), "mup")
    return jax.tree_util.tree_map(np.asarray, jp)


def _weights(jcfg, seed):
    """The reference's init (cached by config and seed: the capacity factor
    changes no weight, so its cases share them)."""
    jp = _init(jcfg.replace(capacity_factor=1.0), seed)
    return (jmoe.moe_meta(jcfg, "moe"), {n: jnp.asarray(a) for n, a in jp.items()},
            params_from_numpy(jp, device="cpu"))


def _x(S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _both(jcfg, tcfg, jmeta, jp, tp, x, jact=None, tact=None):
    # one jit of the reference's call (compiling it op by op costs more)
    act = jact or j_act(jcfg.act.replace("_glu", ""))
    want = jax.jit(lambda p, xx: jmoe.moe_ffn(jcfg, p, jmeta, xx, "mup", act))(
        jp, jnp.asarray(x))
    got = tmoe.moe_ffn(tcfg, tp, tmoe.moe_meta(tcfg, "moe"), torch.from_numpy(x), "mup",
                       tact or t_act(tcfg.act.replace("_glu", "")))
    return got.numpy(), np.asarray(want)


def _probe(E, d, f, jp):
    """The router's weights with experts that write each kept slot's gate
    into column e of its token: x's coordinate 0 is 1 and the activation
    is 1, so expert e's output is the one-hot of e (exact in f32)."""
    wi = np.zeros((E, d, 2 * f), np.float32)
    wo = np.zeros((E, f, d), np.float32)
    for e in range(E):
        wi[e, 0, f + e] = 1.0
        wo[e, e, e] = 1.0
    return dict(router=np.array(jp["router"]), wi=wi, wo=wo)


def _reference_case(jcfg, jmeta, jp, probe, x, xp):
    """The reference's outputs on x, its router logits and top-k experts,
    and its outputs on the probe: one jit (op-by-op dispatch of so many
    small shapes costs more than one compile)."""
    act = j_act(jcfg.act.replace("_glu", ""))

    def f(p, pp, xx, xxp):
        logits = j_apply_w(xx, p["router"], jmeta["router"], "mup", "bsd,de->bse")
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
        return (jmoe.moe_ffn(jcfg, p, jmeta, xx, "mup", act), logits, idx,
                jmoe.moe_ffn(jcfg, pp, jmeta, xxp, "mup", jnp.ones_like))

    return [np.asarray(a) for a in jax.jit(f)(jp, probe, jnp.asarray(x), jnp.asarray(xp))]


@pytest.mark.parametrize("cap", sorted(CAPACITY))
@pytest.mark.parametrize("S", [1, 5, 8, 33, 64])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("E", [2, 4, 8])
def test_moe_ffn_matches_reference(E, k, S, cap):
    """Outputs at the f32 tier; the expert choices equal the reference's
    top-k of its own router probabilities; the probe's kept slots and their
    gates equal the reference's (dropped slots zero on both sides)."""
    jcfg, tcfg = _cfgs(E, k, CAPACITY[cap])
    jmeta, jp, tp = _weights(jcfg, E * 10 + k)
    x = _x(S, D, E * 100 + k * 10 + S)
    xp = x.copy()
    xp[..., 0] = 1.0
    probe = _probe(E, D, FF, jp)
    want, logits, jidx, pwant = _reference_case(
        jcfg, jmeta, jp, {n: jnp.asarray(a) for n, a in probe.items()}, x, xp)
    tmeta = tmoe.moe_meta(tcfg, "moe")
    act = t_act(tcfg.act.replace("_glu", ""))
    got = tmoe.moe_ffn(tcfg, tp, tmeta, torch.from_numpy(x), "mup", act).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    # the expert choices, exactly
    tlogits, _, tidx = tmoe.route(tcfg, tp, tmeta, torch.from_numpy(x), "mup")
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_allclose(tlogits.numpy(), logits, atol=1e-6, rtol=0)

    # the kept and dropped slots, exactly, through the probe
    pgot = tmoe.moe_ffn(tcfg, {n: torch.from_numpy(a) for n, a in probe.items()}, tmeta,
                        torch.from_numpy(xp), "mup", torch.ones_like).numpy()
    np.testing.assert_array_equal(pgot[..., :E] != 0, pwant[..., :E] != 0)
    np.testing.assert_allclose(pgot, pwant, atol=1e-6, rtol=0)
    kept = int((pwant[..., :E] != 0).sum())
    if cap == "ample":
        assert kept == B * S * k                  # nothing dropped
    assert kept <= B * E * tmoe._capacity(tcfg, S)


def test_dispatch_ranks_token_major():
    """The dispatch table on a hand-made routing: expert 0 chosen by every
    slot of three tokens at capacity 2 (top-1) keeps tokens 0 and 1 and
    drops 2; at top-2 slot t = s k + j, token-major then choice."""
    idx = torch.tensor([[[0], [0], [0], [1]]])
    d = tmoe.dispatch(idx, 2, 2)
    assert d.tolist() == [[[0, 1], [3, 4]]]       # 4 = T: an empty place
    idx = torch.tensor([[[1, 0], [0, 1], [0, 1]]])
    d = tmoe.dispatch(idx, 2, 2)
    assert d.tolist() == [[[1, 2], [0, 3]]]       # slots 4 and 5 (token 2) dropped


@pytest.mark.parametrize("S", [1, 5, 64, 256, 4608])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_capacity_equals_reference(arch, S):
    """C over each call's own S: a decode token (S 1: the floor of 8), a
    verify of draft_k + 1 = 5, a chunk (64, 256) and mixtral's padded
    prefill buffer of 4,608, at the configs' own factors and at 1e-6 and 8."""
    for cf in (None, 1e-6, 8.0):
        jc, tc = j_config(arch), t_config(arch)
        if cf is not None:
            jc, tc = jc.replace(capacity_factor=cf), tc.replace(capacity_factor=cf)
        assert tmoe._capacity(tc, S) == jmoe._capacity(jc, S)
    assert tmoe._capacity(t_config("mixtral-8x22b"), 4608) == 1440
    assert tmoe._capacity(t_config("mixtral-8x22b"), 1) == 8


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (3, 7, 2))
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("p13n", ["mup", "mup_table9", "umup", "sp"])
def test_router_multiplier_and_init_match_reference(p13n):
    """Every MoE tensor's abc rule (multiplier, init std, lr multipliers)
    equals the reference's; under µP the router is output-like: its
    multiplier goes as 1 / width_mult (router temperature transfers)."""
    jcfg, tcfg = _cfgs(4, 2, 1.25)
    for mult in (1, 4):
        jc = jcfg.replace(d_model=D * mult, d_ff=FF * mult)
        tc = tcfg.replace(d_model=D * mult, d_ff=FF * mult)
        jm, tm = jmoe.moe_meta(jc, "moe"), tmoe.moe_meta(tc, "moe")
        for name in ("router", "wi", "wo"):
            assert tm[name].infshape.shape == jm[name].infshape.shape
            tr, jr = tm[name].rule(p13n), jm[name].rule(p13n)
            for f in ("multiplier", "init_std", "sgd_lr_mult", "adam_lr_mult", "wd_mult"):
                assert getattr(tr, f) == pytest.approx(getattr(jr, f)), (name, f)
    base = tmoe.moe_meta(tcfg, "moe")["router"].rule("mup").multiplier
    wide = tmoe.moe_meta(tcfg.replace(d_model=4 * D), "moe")["router"].rule("mup").multiplier
    assert wide == pytest.approx(base / 4)


@pytest.mark.parametrize("k", [1, 2])
def test_ties_go_to_the_lower_expert(k):
    """A router of zeros gives every expert the same probability: the
    reference's top_k picks experts 0 .. k-1, and so does the port."""
    jcfg, tcfg = _cfgs(8, k, 1.25)
    jmeta, jp, tp = _weights(jcfg, 0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(5, D, 3)
    _, _, tidx = tmoe.route(tcfg, tp, tmoe.moe_meta(tcfg, "moe"), torch.from_numpy(x), "mup")
    assert (tidx == torch.arange(k)).all()
    got, want = _both(jcfg, tcfg, jmeta, jp, tp, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_no_copy_of_the_expert_weights():
    """A decode-sized call (B 1, S 1: 8 rows an expert) makes no tensor as
    large as an expert weight: the weights are read in place, never cast or
    copied (at mixtral's width a copy would double a decode step's bytes)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tcfg = _cfgs(4, 2, 1.25, d=48, f=96)
    tmeta = tmoe.moe_meta(tcfg, "moe")
    g = torch.Generator().manual_seed(0)
    tp = {n: torch.randn(m.infshape.shape, generator=g) for n, m in tmeta.items()}
    weights = {tp[n].untyped_storage().data_ptr() for n in ("wi", "wo")}
    sizes = []

    class Sizes(TorchDispatchMode):
        """Every new tensor the call makes (views of the weights skipped)."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor)
                        and t.untyped_storage().data_ptr() not in weights):
                    sizes.append((str(func), t.numel()))
            return out

    x = torch.randn(1, 1, 48, generator=g)
    with Sizes():
        tmoe.moe_ffn(tcfg, tp, tmeta, x, "mup", torch.nn.functional.silu)
    big = [s for s in sizes if s[1] >= tp["wo"].numel()]
    assert not big, big
