"""The port's model against the reference on the same weights and inputs.

Weights come from the reference's init (with ``zero_init_query=False``, so
attention is not uniform) and move into the port by dotted name through
``convert.params_from_numpy``.  Logits are compared at f32 atol/rtol 1e-4:
both sides compute in float32, and the gap is the summation order of two
matmul libraries across a few layers.

Two configs: smollm-135m's smoke config (GQA, silu-GLU, at its own base
shape) and mup-gpt at 1/8 width (d_model 128 against base 256), where the
µP multipliers and the attention scale differ from SP's, so a wrong
multiplier shows.  Init is held to the abc rules by its statistics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.meta import flatten_meta as jflatten_meta  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)

CONFIGS = {
    "smollm-135m-smoke": lambda m: m.get_smoke_config("smollm-135m").replace(
        dtype="float32", zero_init_query=False),
    "mup-gpt@0.125x": lambda m: m.get_config("mup-gpt").replace(
        n_layers=2, dtype="float32", zero_init_query=False).scaled(0.125),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(reference model, its params, port model, the same params)."""
    make = CONFIGS[request.param]
    jm = jbuild(make(jconfigs))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(make(tconfigs), device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def test_config_and_param_layout_match(pair):
    jm, _, tm, tp = pair
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
              "vocab_size", "base_d_model", "base_d_head", "base_d_ff", "act",
              "parametrization", "dtype", "zero_init_query", "tie_embeddings"):
        assert getattr(tm.cfg, f) == getattr(jm.cfg, f), f
    jflat = jflatten_meta(jm.meta)
    assert sorted(jflat) == sorted(tm.flat_meta) == sorted(tp)
    for name, m in jflat.items():
        assert tuple(tp[name].shape) == m.infshape.shape, name
        assert tm.flat_meta[name].infshape.shape == m.infshape.shape


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_logits_match(pair, mode):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg, (2, 12), seed=1)
    jl, jc = jm.forward(jp, jnp.asarray(toks), mode=mode, cache_len=16)
    tl, tc = tm.forward(tp, torch.as_tensor(toks), mode=mode, cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if mode == "prefill":
        last, _ = tm.prefill(tp, torch.as_tensor(toks), cache_len=16)
        np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **TOL)
        for key, jcache in jc["groups"].items():
            tcache = tc["groups"][key]["attn"]
            np.testing.assert_array_equal(tcache["pos"].numpy(),
                                          np.asarray(jcache["attn"]["pos"]))
            for leaf in ("k", "v"):
                np.testing.assert_allclose(tcache[leaf].numpy(),
                                           np.asarray(jcache["attn"][leaf]), **TOL)


def _admitted(jm, jp, tm, tp, plens, Pmax, spec_args):
    """Both sides' pools after admitting one prompt per slot (last slot left
    empty), plus the tables and the prompts."""
    S = len(plens) + 1
    jspec = jkv.build_spec(jm.cfg, S, *spec_args)
    tspec = tkv.build_spec(tm.cfg, S, *spec_args)
    jgt, _ = jkv.make_tables(jspec)
    tgt = tkv.make_tables(tspec, "cpu")
    jpools = jkv.init_pools(jm.cfg, jspec)
    tpools = tkv.init_pools(tm.cfg, tspec, "cpu")
    prompts = _tokens(jm.cfg, (S, Pmax), seed=2)
    idx = np.arange(Pmax)
    for s, plen in enumerate(plens):
        pos = np.where(idx < plen, idx, Pmax)[None].astype(np.int32)
        _, jpc = jm.forward(jp, jnp.asarray(prompts[s:s + 1]),
                            positions=jnp.asarray(pos), mode="prefill",
                            cache_len=Pmax, full_cache=True)
        jpools = jkv.admit_slot(jpools, jpc, jm.cfg, jspec, jgt[s], None,
                                jnp.int32(plen))
        _, tpc = tm.forward(tp, torch.as_tensor(prompts[s:s + 1]),
                            positions=torch.as_tensor(pos), mode="prefill",
                            cache_len=Pmax)
        tkv.admit_slot(tpools, tpc, tm.cfg, tspec, tgt[s], plen)
    return jpools, tpools, jgt, tgt, prompts


def _assert_pools_match(jpools, tpools):
    """pos identical everywhere; k/v equal wherever an entry was written."""
    for key, jpool in jpools["groups"].items():
        jp_, tp_ = jpool["attn"], tpools["groups"][key]["attn"]
        jpos = np.asarray(jp_["pos"])
        np.testing.assert_array_equal(tp_["pos"].numpy(), jpos)
        live = jpos >= 0
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tp_[leaf].numpy()[live],
                                       np.asarray(jp_[leaf])[live], **TOL)


def test_paged_decode_logits_match(pair):
    """Admission into pages, then two decode steps over the paged pools with
    one slot inactive: logits and pools agree after every step."""
    jm, jp, tm, tp = pair
    plens, Pmax, P = (5, 11), 12, 4
    jpools, tpools, jgt, tgt, _ = _admitted(jm, jp, tm, tp, plens, Pmax,
                                            (Pmax + 4, P))
    _assert_pools_match(jpools, tpools)
    active = np.array([True, True, False])
    pos = np.array([plens[0], plens[1], 0])
    for step in range(2):
        toks = _tokens(jm.cfg, (3, 1), seed=10 + step)
        qpos = np.where(active, pos, -1)[:, None].astype(np.int32)
        jpaged = jkv.PagedState(global_table=jgt, window_table=None,
                                active=jnp.asarray(active), page_size=P)
        jl, jpools = jm.forward(jp, jnp.asarray(toks), positions=jnp.asarray(qpos),
                                mode="decode", cache=jpools, paged=jpaged)
        tpaged = tkv.PagedState(global_table=tgt, active=torch.as_tensor(active),
                                page_size=P)
        tl, tpools = tm.forward(tp, torch.as_tensor(toks),
                                positions=torch.as_tensor(qpos), mode="decode",
                                cache=tpools, paged=tpaged)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_pools_match(jpools, tpools)
        pos = pos + active


def test_init_statistics_follow_the_abc_rule(pair):
    """Per-tensor std = rule.init_std (zeros where init='zeros'), from the
    port's own torch.Generator draws."""
    _, _, tm, _ = pair
    params = tm.init(seed=3)
    for name, m in tm.flat_meta.items():
        w = params[name]
        assert w.dtype == torch.float32 and tuple(w.shape) == m.infshape.shape
        if m.init == "zeros":
            assert torch.count_nonzero(w) == 0, name
            continue
        want = m.rule(tm.p13n, tm.cfg.sigma).init_std
        n = w.numel()
        # the sample std of n normals is within ~5/sqrt(2n) of the truth
        assert abs(w.std().item() / want - 1) < 5 / np.sqrt(2 * n) + 1e-3, name
        assert abs(w.mean().item()) < 5 * want / np.sqrt(n), name


def test_model_defaults_to_the_card():
    cfg = tconfigs.get_smoke_config("smollm-135m")
    if torch.cuda.is_available():
        assert tbuild(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbuild(cfg)
