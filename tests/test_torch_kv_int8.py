"""The int8 paged KV cache of the port (``--kv-dtype int8``) against the
reference: ``quant/kv``, the scale lifecycle of ``serving/kv_cache``, the
plain int8 modes of B8 and B9, the model's paged int8 decode, and both
engines end to end; on a card only, the CUDA int8 modes against their plain
versions.

Tolerance tiers (the reference's, ``tests/test_kv_int8.py``):
  TIGHT (2e-5): int8 decode against int8 decode on the same bytes and
    scales (the port's plain version against the reference's Pallas kernel
    in interpret mode; on the card the CUDA kernel against its plain
    version): the same dequantized f32 values, the same f32 math.
  LOOSE (5e-2): int8 decode against the f32 attention of the unquantized
    K/V (per-page absmax/127 half steps through the softmax).
  Pools: fed the same numpy k/v, the port's writes, admission and
    invalidation give the reference's int8 bytes and f32 scales exactly
    (half-to-even rounding and IEEE division in both).
  Serving: greedy tokens equal to the reference's int8 engines on the same
    weights, at least 99% top-1 agreement with the port's f32 engine (the
    reference's bar), and the dynamic engine's tokens the same with the
    prefix cache on, warm, and under eviction as with it off.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import quant  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

TIGHT = 2e-5
LOOSE = 5e-2
_ENG = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=6)


@pytest.fixture(scope="module")
def jx():
    """The reference, imported only by the tests that compare with it (the
    machine with the card runs the GPU tests without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import quant as jquant
    from repro.configs import get_smoke_config
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import flash_decode, flash_decode_multi
    from repro.models.model import build_model
    from repro.serving import engine as jengine
    from repro.serving import kv_cache as jkv

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, quant=jquant, smoke=get_smoke_config,
        ref=jref, flash_decode=flash_decode, flash_decode_multi=flash_decode_multi,
        build_model=build_model, engine=jengine, kv=jkv,
    )


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# quant: primitives and pack/unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 4, 2, 8), (2, 5, 16, 1, 16)])
def test_pack_kv_bytes_equal_reference_and_round_trip(jx, shape):
    """pack_kv gives the reference's bytes and scales; unpack is within half
    a step of the input (a page of zeros stays zeros)."""
    rng = np.random.default_rng(sum(shape))
    k = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-3] + (1, 1, 1))
         ).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    v[0] = 0.0
    got = quant.pack_kv(torch.from_numpy(k), torch.from_numpy(v))
    want = jx.quant.pack_kv(jx.jnp.asarray(k), jx.jnp.asarray(v))
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 or g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    kd, vd = quant.unpack_kv(*got)
    for x, xd, s in ((k, kd, got[2]), (v, vd, got[3])):
        half = s.numpy()[..., None, :, None] / 2
        assert np.all(np.abs(xd.numpy() - x) <= half * (1 + 1e-6))
    assert torch.count_nonzero(vd[0]) == 0


def test_quantize_int8_matches_reference(jx):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 33)) * 3).astype(np.float32)
    x[2] = 0.0
    for axis in (-1, 0):
        q, s = quant.quantize_int8(torch.from_numpy(x), axis=axis)
        jq, js = jx.quant.quantize_int8(jx.jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(quant.dequantize_int8(q, s).numpy(),
                                      np.asarray(jx.quant.dequantize_int8(jq, js)))


def test_round_half_to_even_as_the_reference():
    """torch.round rounds ties to even, as jnp.round does: 2.5 -> 2."""
    x = torch.tensor([0.5, 1.5, 2.5, -2.5, 127.0]).reshape(1, 1, 5)   # (P, K, hd)
    q = quant.quantize_with(x, torch.ones(1))
    assert q.reshape(-1).tolist() == [0, 2, 2, -2, 127]


# ---------------------------------------------------------------------------
# the scale lifecycle: write / requantize / gather / invalidate
# ---------------------------------------------------------------------------

def _int8_cache(N, P, K, hd):
    return {
        "k": torch.zeros((N, P, K, hd), dtype=torch.int8),
        "v": torch.zeros((N, P, K, hd), dtype=torch.int8),
        "pos": torch.full((N, P), -1, dtype=torch.int32),
        "k_scale": torch.zeros((N, K)),
        "v_scale": torch.zeros((N, K)),
    }


def _write(cache, k_new, v_new, positions, tab, P):
    return tkv.paged_cache_write(cache, k_new, v_new, positions, tab,
                                 torch.tensor([True]), P)


def test_paged_write_scale_grows_and_requants():
    """The reference's test_paged_write_scale_grows_and_requants on the
    port: a larger token grows the page's scale and requantizes the earlier
    token within a step; a smaller one leaves scale and bytes as they are."""
    P, K, hd = 4, 2, 8
    cache = _int8_cache(6, P, K, hd)
    tab = torch.tensor([[0, 2, 4]], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    small = 0.1 * torch.randn(1, 1, K, hd, generator=g)
    _write(cache, small, small, torch.tensor([[0]]), tab, P)
    s1 = cache["k_scale"].clone()
    assert s1[0].max() > 0 and s1[1:].max() == 0        # only page 0 touched

    big = 10.0 * torch.randn(1, 1, K, hd, generator=g)
    _write(cache, big, big, torch.tensor([[1]]), tab, P)
    s2 = cache["k_scale"].clone()
    assert torch.all(s2 >= s1) and torch.all(s2[0] > s1[0])
    deq0 = cache["k"][0, 0].float() * s2[0][:, None]
    assert torch.all((deq0 - small[0, 0]).abs() <= s2[0][:, None])

    k2 = cache["k"].clone()
    _write(cache, small, small, torch.tensor([[2]]), tab, P)
    assert torch.equal(cache["k_scale"], s2)
    assert torch.equal(cache["k"][0, :2], k2[0, :2])
    assert cache["pos"][0].tolist() == [0, 1, 2, -1]


def _stack_write(jx, jpools, tpools, key, k_new, v_new, positions, tab, active, P):
    """paged_cache_write on every layer of one group, in both frameworks:
    the reference on each layer's leaves, the port on views into its
    stacked pool."""
    jpool = jpools["groups"][key]["attn"]
    tpool = tpools["groups"][key]["attn"]
    L = tpool["k"].shape[0]
    new = []
    for layer in range(L):
        leaf = {n: t[layer] for n, t in jpool.items()}
        new.append(jx.kv.paged_cache_write(
            leaf, jx.jnp.asarray(k_new[layer]), jx.jnp.asarray(v_new[layer]),
            jx.jnp.asarray(positions), jx.jnp.asarray(tab), jx.jnp.asarray(active),
            P, ring=False))
        tkv.paged_cache_write(
            {n: t[layer] for n, t in tpool.items()}, torch.from_numpy(k_new[layer]),
            torch.from_numpy(v_new[layer]), torch.from_numpy(positions),
            torch.from_numpy(tab), torch.from_numpy(active), P)
    jpools["groups"][key]["attn"] = {n: jx.jnp.stack([c[n] for c in new]) for n in jpool}


def _assert_pools_equal(jpools, tpools, what):
    for key, tp in tpools["groups"].items():
        jp = jpools["groups"][key]["attn"]
        assert set(jp) == set(tp["attn"]), what
        for name, t in tp["attn"].items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jp[name]),
                                          err_msg=f"{what}: {key} {name}")


def test_pools_byte_exact_against_reference(jx):
    """A sequence of an admission, decode writes (one slot inactive), a
    chunk with a row at -1 and a token 20x the page's absmax (scale growth,
    requantization), an invalidation (ids past the pool dropped) and a write
    into the invalidated page (ratio 0 wipes its stale bytes): after every
    step the port's int8 bytes, f32 scales and positions equal the
    reference's."""
    jcfg = jx.smoke("smollm-135m", dtype="float32", kv_dtype="int8")
    tcfg = t_smoke("smollm-135m", dtype="float32", kv_dtype="int8")
    P = 4
    jspec = jx.kv.build_spec(jcfg, 2, 16, P)
    tspec = tkv.build_spec(tcfg, 2, 16, P)
    jpools = jx.kv.init_pools(jcfg, jspec)
    tpools = tkv.init_pools(tcfg, tspec, "cpu")
    _assert_pools_equal(jpools, tpools, "init")
    L, K, hd = tcfg.n_groups, tcfg.n_kv_heads, tcfg.d_head
    key = "0_attn"
    rng = np.random.default_rng(5)
    gtab = np.asarray(tkv.make_tables(tspec, "cpu")[0])        # (2, 4) interleaved

    # admission of slot 0: a 7-token prompt out of a 12-token buffer
    Pmax, plen = 12, 7
    src = {n: (rng.standard_normal((L, 1, Pmax, K, hd))
               * rng.uniform(0.05, 4, (L, 1, Pmax, K, 1))).astype(np.float32)
           for n in ("k", "v")}
    jnew = jx.kv.admit_slot(
        jpools, {"groups": {key: {"attn": {n: jx.jnp.asarray(a) for n, a in src.items()}}},
                 "tail": {}},
        jcfg, jspec, jx.jnp.asarray(gtab[0]), None, jx.jnp.int32(plen))
    jpools = {"groups": jnew["groups"], "tail": {}}
    tkv.admit_slot(tpools, {"groups": {key: {"attn": {
        n: torch.from_numpy(a) for n, a in src.items()}}}}, tcfg, tspec,
        torch.from_numpy(gtab[0]), plen)
    _assert_pools_equal(jpools, tpools, "admission")

    def step(what, B, T, positions, tab, active, mag):
        kn, vn = ((rng.standard_normal((L, B, T, K, hd)) * mag).astype(np.float32)
                  for _ in range(2))
        _stack_write(jx, jpools, tpools, key, kn, vn, np.asarray(positions, np.int32),
                     np.asarray(tab, np.int32), np.asarray(active), P)
        _assert_pools_equal(jpools, tpools, what)

    step("decode, slot 1 inactive", 2, 1, [[7], [0]], gtab, [True, False], 0.5)
    step("decode, a large token", 2, 1, [[8], [0]], gtab, [True, False], 20.0)
    step("chunk, last row at -1", 1, 5, [[0, 1, 2, 3, -1]], gtab[1:], [True], 1.0)
    step("chunk across pages", 1, 4, [[9, 10, 11, 12]], gtab[:1], [True], 3.0)
    ids = np.array([gtab[0, 1], gtab[1, 0], 99], np.int32)       # 99: past the pool
    jpools = {"groups": jx.kv.invalidate_pages(jpools, jcfg, jx.jnp.asarray(ids))["groups"],
              "tail": {}}
    tkv.invalidate_pages(tpools, tcfg, ids)
    _assert_pools_equal(jpools, tpools, "invalidation")
    step("first write into an invalidated page", 2, 1, [[4], [0]], gtab, [True, True], 0.2)


def test_gather_slot_dequantizes_within_halfstep(jx):
    P, K, hd, T = 4, 2, 8, 8
    cache = _int8_cache(8, P, K, hd)
    tab = torch.tensor([[1, 5]], dtype=torch.int32)
    g = torch.Generator().manual_seed(3)
    k_new, v_new = torch.randn(1, T, K, hd, generator=g), torch.randn(1, T, K, hd, generator=g)
    positions = torch.arange(T, dtype=torch.int32)[None]
    _write(cache, k_new, v_new, positions, tab, P)
    view = tkv.gather_slot(cache, tab[0])
    assert view["k"].dtype == torch.float32
    assert view["pos"][:T].tolist() == list(range(T))
    step = float(cache["k_scale"].max())
    assert torch.all((view["k"][:T] - k_new[0]).abs() <= step / 2 + 1e-6)
    jview = jx.kv.gather_slot({n: jx.jnp.asarray(t.numpy()) for n, t in cache.items()},
                              jx.jnp.asarray(tab[0].numpy()))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(view[name].numpy(), np.asarray(jview[name]))


def test_invalidate_pages_zeroes_scales():
    cfg = t_smoke("smollm-135m", dtype="float32", kv_dtype="int8")
    spec = tkv.build_spec(cfg, n_slots=2, max_total=16, page_size=4)
    pools = tkv.init_pools(cfg, spec, "cpu")
    leaf = pools["groups"]["0_attn"]["attn"]
    for name in ("k_scale", "v_scale"):
        leaf[name].fill_(1.0)
    leaf["pos"].fill_(0)
    tkv.invalidate_pages(pools, cfg, torch.tensor([0, 3, 8], dtype=torch.int32))
    for p in (0, 3):
        assert leaf["k_scale"][:, p].max() == 0 and leaf["v_scale"][:, p].max() == 0
        assert leaf["pos"][:, p].max() == -1
    assert leaf["k_scale"][:, 1].min() == 1 and leaf["pos"][:, 1].min() == 0


def test_pool_bytes_int8_capacity_ratio(jx):
    """At a fixed byte budget int8 pools hold >= 1.8x the pages of bf16
    pools, scales included; every footprint equals the reference's."""
    tcfg = t_smoke("smollm-135m", dtype="float32")
    jcfg = jx.smoke("smollm-135m", dtype="float32")
    spec = tkv.build_spec(tcfg, n_slots=8, max_total=48, page_size=16)
    jspec = jx.kv.build_spec(jcfg, n_slots=8, max_total=48, page_size=16)
    got = {d: tkv.pool_bytes(tcfg.replace(kv_dtype=d), spec)
           for d in ("bfloat16", "int8", "float32")}
    for d, n in got.items():
        assert n == jx.kv.pool_bytes(jcfg.replace(kv_dtype=d), jspec), d
    assert got["bfloat16"] / got["int8"] >= 1.8
    assert tkv.kv_dtype_of(tcfg.replace(kv_dtype="int8")) == "int8"
    pools = tkv.init_pools(tcfg.replace(kv_dtype="int8"), spec, "cpu")
    leaf = pools["groups"]["0_attn"]["attn"]
    held = sum(t.numel() * t.element_size() for t in leaf.values())
    assert held * len(pools["groups"]) == got["int8"]


# ---------------------------------------------------------------------------
# the plain int8 modes of B8 and B9 against the reference's kernel
# ---------------------------------------------------------------------------

def paged_case(B, K, G, d, P, C, hist, T=1, dead=(), seed=0):
    """f32 pools holding hist[b] + T tokens of slot b (history, then a
    T-query chunk), written through a permuted page table, stale random
    bytes elsewhere; ``dead`` (b, t) rows at q_pos -1 (not written).
    Returns the arrays and the f32 dense band each slot attends over."""
    rng = np.random.default_rng(seed)
    H, N = K * G, B * C + 3
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    kp = rng.standard_normal((N, P, K, d)).astype(np.float32)
    vp = (rng.standard_normal((N, P, K, d))
          * rng.uniform(0.1, 3, (N, 1, K, 1))).astype(np.float32)
    tab = rng.permutation(N)[:B * C].reshape(B, C).astype(np.int32)
    q_pos = np.stack([np.arange(h, h + T) for h in hist]).astype(np.int32)
    for b, t in dead:
        q_pos[b, t] = -1
    pos = np.full((N, P), -1, np.int32)
    for b, h in enumerate(hist):
        for t in [*range(h), *q_pos[b][q_pos[b] >= 0]]:
            pos[tab[b, t // P], t % P] = t
    return q, kp, vp, pos, tab, q_pos


def _int8_args(case):
    q, kp, vp, pos, tab, q_pos = case
    kq, vq, ks, vs = quant.pack_kv(torch.from_numpy(kp), torch.from_numpy(vp))
    return (torch.from_numpy(q), kq, vq, torch.from_numpy(pos), torch.from_numpy(tab),
            torch.from_numpy(q_pos)), dict(k_scale=ks, v_scale=vs)


def _j(jx, args, scales):
    return ([jx.jnp.asarray(a.numpy()) for a in args],
            {n: jx.jnp.asarray(s.numpy()) for n, s in scales.items()})


DECODE_CASES = [
    # (K, G, window, softcap)
    (1, 4, 0, 0.0),      # MQA
    (2, 2, 0, 0.0),      # GQA
    (4, 1, 0, 0.0),      # MHA
    (3, 3, 9, 0.0),      # smollm's grouping, window
    (2, 2, 0, 30.0),
    (1, 4, 9, 30.0),
]


@pytest.mark.parametrize("K,G,window,softcap", DECODE_CASES)
def test_int8_decode_plain_matches_reference_kernel(jx, K, G, window, softcap):
    """B8's int8 mode: the port's plain version (ops on the CPU) against the
    reference's Pallas kernel in interpret mode and its plain version at
    TIGHT on the same bytes and scales, an inactive slot exactly zero; and
    within LOOSE of the f32 attention over the unquantized pools."""
    case = paged_case(3, K, G, 8, 4, 6, [21, 0, 13], dead=((1, 0),))
    args, scales = _int8_args(case)
    args = (args[0][:, 0], *args[1:5], args[5][:, 0])
    kw = dict(scale=0.125, window=window, softcap=softcap)
    got = ops.decode_attention(*args, **kw, **scales)
    jargs, jscales = _j(jx, args, scales)
    want_k = jx.flash_decode(*jargs, **kw, **jscales, interpret=True)
    want_r = jx.ref.decode_attention_ref(*jargs, **kw, **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), atol=TIGHT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_r), atol=TIGHT)
    assert torch.count_nonzero(got[1]) == 0
    f32 = ops.decode_attention(args[0], *(torch.from_numpy(a) for a in case[1:3]),
                               *args[3:], **kw)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=LOOSE)


MULTI_CASES = [
    # (K, G, window, softcap, T)
    (1, 4, 0, 0.0, 5),
    (2, 2, 0, 0.0, 5),
    (4, 1, 7, 0.0, 6),
    (3, 3, 0, 0.0, 8),
    (2, 2, 9, 30.0, 5),
    (1, 4, 0, 20.0, 1),
]


@pytest.mark.parametrize("K,G,window,softcap,T", MULTI_CASES)
def test_int8_multi_plain_matches_reference_kernel(jx, K, G, window, softcap, T):
    """B9's int8 mode, as B8's: two slots, one with a row at -1, one whose
    history ends mid-page."""
    dead = ((1, T - 1),)
    case = paged_case(2, K, G, 8, 4, 6, [9, 13], T=T, dead=dead, seed=1)
    args, scales = _int8_args(case)
    kw = dict(scale=0.125, window=window, softcap=softcap)
    got = ops.decode_attention_multi(*args, **kw, **scales)
    jargs, jscales = _j(jx, args, scales)
    want_k = jx.flash_decode_multi(*jargs, **kw, **jscales, interpret=True)
    want_r = jx.ref.decode_attention_multi_ref(*jargs, **kw, **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), atol=TIGHT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_r), atol=TIGHT)
    assert torch.count_nonzero(got[1, T - 1]) == 0
    f32 = ops.decode_attention_multi(args[0], *(torch.from_numpy(a) for a in case[1:3]),
                                     *args[3:], **kw)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=LOOSE)
    if T == 1:       # one row: the single-query mode on the same inputs
        one = ops.decode_attention(args[0][:, 0], *args[1:5], args[5][:, 0], **kw, **scales)
        np.testing.assert_allclose(got[:, 0].numpy(), one.numpy(), atol=TIGHT)


def test_int8_dispatch_contract():
    """Scales go with int8 pools and only with them; impl="kernel" on the
    CPU raises; the CPU path launches nothing."""
    args, scales = _int8_args(paged_case(2, 2, 2, 8, 4, 3, [5, 9]))
    b8 = (args[0][:, 0], *args[1:5], args[5][:, 0])
    ops.reset_launch_counts()
    for fn, a in ((ops.decode_attention, b8), (ops.decode_attention_multi, args)):
        fn(*a, scale=0.3, **scales)
        with pytest.raises(ValueError, match="k_scale and v_scale"):
            fn(*a, scale=0.3)
        with pytest.raises(ValueError, match="go with int8 pools"):
            fn(a[0], a[1].float(), a[2].float(), *a[3:], scale=0.3, **scales)
        with pytest.raises(ValueError, match="CUDA"):
            fn(*a, scale=0.3, impl="kernel", **scales)
    with pytest.raises(ValueError, match="CUDA"):
        da.flash_decode(*b8, **scales)
    with pytest.raises(ValueError, match="CUDA"):
        da.flash_decode_multi(*args, **scales)
    counts = ops.launch_counts()
    assert set(counts.values()) == {0}
    assert {"flash_decode_int8", "flash_decode_multi_int8"} <= set(counts)


# ---------------------------------------------------------------------------
# the model's paged int8 decode, and the engines end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(jx):
    """Reference and port smollm smoke models on the same weights (a random
    query projection, so attention is not uniform), f32 and int8 pools."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import build_model as tbuild

    over = dict(dtype="float32", zero_init_query=False)
    jcfg, tcfg = jx.smoke("smollm-135m", **over), t_smoke("smollm-135m", **over)
    jm = jx.build_model(jcfg)
    jm8 = jx.build_model(jcfg.replace(kv_dtype="int8"))
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tm8 = tbuild(tcfg.replace(kv_dtype="int8"), device="cpu")
    tp = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jm=jm, jm8=jm8, jp=jp, tm=tm, tm8=tm8, tp=tp)


@pytest.mark.parametrize("T", [1, 5])
def test_paged_int8_decode_forward_matches_reference_model(jx, models, T):
    """A decode-mode forward (a T-token chunk per slot) over the same int8
    pools (stale bytes, permuted pages, one slot inactive, one row at -1):
    logits within atol = rtol = 1e-4 of the reference model's; positions and
    scales written equal, k/v bytes within one step (the frameworks' f32
    k/v differ by ulps, which can move a byte across a half step)."""
    m = models
    cfg = m.jm8.cfg
    S, P, max_total = 3, 4, 24
    jspec = jx.kv.build_spec(cfg, S, max_total, P)
    tspec = tkv.build_spec(m.tm8.cfg, S, max_total, P)
    jpools = jx.kv.init_pools(cfg, jspec)
    tpools = tkv.init_pools(m.tm8.cfg, tspec, "cpu")
    rng = np.random.default_rng(7)
    N = tspec.n_global_pages
    tab = rng.permutation(N)[:S * tspec.gp_cols].reshape(S, -1).astype(np.int32)
    hist = [9, 0, 14]
    for key, jp_ in jpools["groups"].items():
        tp_ = tpools["groups"][key]["attn"]
        for leaf in ("k", "v"):
            a = rng.integers(-127, 128, jp_["attn"][leaf].shape).astype(np.int8)
            s = rng.uniform(0.001, 0.05, jp_["attn"][leaf + "_scale"].shape).astype(np.float32)
            jp_["attn"][leaf] = jx.jnp.asarray(a)
            jp_["attn"][leaf + "_scale"] = jx.jnp.asarray(s)
            tp_[leaf].copy_(torch.from_numpy(a))
            tp_[leaf + "_scale"].copy_(torch.from_numpy(s))
        pos = np.full((cfg.n_groups, N, P), -1, np.int32)
        for s_, h in enumerate(hist):
            for t in range(h):
                pos[:, tab[s_, t // P], t % P] = t
        jp_["attn"]["pos"] = jx.jnp.asarray(pos)
        tp_["pos"].copy_(torch.from_numpy(pos))
    positions = np.stack([np.arange(h, h + T) for h in hist]).astype(np.int32)
    positions[2, -1] = -1
    active = np.array([True, False, True])
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    jpaged = jx.kv.PagedState(global_table=jx.jnp.asarray(tab), window_table=None,
                              active=jx.jnp.asarray(active), page_size=P)
    want, jnew = m.jm8.forward(m.jp, jx.jnp.asarray(tokens),
                               positions=jx.jnp.asarray(positions), mode="decode",
                               cache=jpools, paged=jpaged)
    tpaged = tkv.PagedState(global_table=torch.from_numpy(tab),
                            active=torch.from_numpy(active), page_size=P)
    ops.reset_launch_counts()
    got, _ = m.tm8.forward(m.tp, torch.from_numpy(tokens),
                           positions=torch.from_numpy(positions), mode="decode",
                           cache=tpools, paged=tpaged)
    assert set(ops.launch_counts().values()) == {0}
    live = np.broadcast_to(active[:, None], positions.shape) & (positions >= 0)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)
    for key in tpools["groups"]:
        jpool, tpool = jnew["groups"][key]["attn"], tpools["groups"][key]["attn"]
        np.testing.assert_array_equal(tpool["pos"].numpy(), np.asarray(jpool["pos"]))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tpool[leaf + "_scale"].numpy(),
                                       np.asarray(jpool[leaf + "_scale"]), rtol=1e-5)
            diff = np.abs(tpool[leaf].numpy().astype(np.int32)
                          - np.asarray(jpool[leaf]).astype(np.int32))
            assert diff.max() <= 1


def _shared_prefix_prompts(V, R=5, L=16, seed=23):
    """The reference's workload: rows 0..R-2 share an 8-token (2-page)
    prefix; the last is disjoint."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, V, size=8)
    rows = [np.concatenate([base, rng.integers(0, V, size=L - 8)]) for _ in range(R - 1)]
    rows.append(rng.integers(0, V, size=L))
    lens = np.concatenate([rng.integers(10, L + 1, size=R - 1), [L]])
    return np.stack(rows).astype(np.int32), lens.astype(np.int32)


def _mixed_prompts(V, R=5, L=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (R, L)).astype(np.int32),
            rng.integers(1, L + 1, R).astype(np.int32))


TIE_GAP = 1e-5   # chip_smoke.py's near-tie rule


def _greedy_equal(jx, jm, jp, prompts, lens, got, want):
    """Greedy tokens equal request by request, or the first difference is a
    near-tie: there the reference model's full-sequence forward over the
    prompt and ``want``'s tokens so far has a top-2 gap below TIE_GAP.
    Lengths must be equal where no tie was met."""
    ties = 0
    for r in range(len(lens)):
        a = np.asarray(got["tokens"])[r, :int(got["lengths"][r])]
        b = np.asarray(want["tokens"])[r, :int(want["lengths"][r])]
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        if len(diff) == 0:
            assert len(a) == len(b), r
            continue
        j = int(diff[0])
        seq = np.concatenate([prompts[r, :lens[r]], b[:j]])[None]
        logits, _ = jm.forward(jp, jx.jnp.asarray(seq))
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < TIE_GAP, (r, j, top2)
        ties += 1
    return ties


@pytest.mark.parametrize("engine", ["static", "dynamic", "dynamic_chunk4_prefix_cache"])
def test_int8_engines_match_reference_int8_engines(jx, models, engine):
    """The port's int8 engines against the reference's on the same weights:
    greedy tokens (near-tie rule) and, with no tie met, lengths and steps."""
    from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig

    m = models
    knobs = dict(prefill_chunk=4, prefix_cache=True) if "chunk4" in engine else {}
    prompts, lens = _shared_prefix_prompts(m.jm.cfg.vocab_size)
    if engine == "static":
        ours = Engine(m.tm8, EngineConfig(**_ENG))
        theirs = jx.engine.Engine(m.jm8, jx.engine.EngineConfig(**_ENG))
    else:
        ours = DynamicEngine(m.tm8, EngineConfig(**_ENG, **knobs))
        theirs = jx.engine.DynamicEngine(m.jm8, jx.engine.EngineConfig(**_ENG, **knobs))
    got, want = ours.serve(m.tp, prompts, lens), theirs.serve(m.jp, prompts, lens)
    if _greedy_equal(jx, m.jm, m.jp, prompts, lens, got, want) == 0:
        assert got["steps"] == int(want["steps"])
    if knobs:
        assert got["prefill_cached"] == want["prefill_cached"] > 0


@pytest.mark.parametrize("engine", ["static", "dynamic_chunk4_prefix_cache"])
def test_int8_top1_agreement_with_f32_engine(models, engine):
    """>= 99% greedy top-1 agreement with the port's f32 engine on the same
    weights, only the pool dtype differing (the reference's bar)."""
    from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig

    m = models
    if engine == "static":
        make = lambda model: Engine(model, EngineConfig(**_ENG))  # noqa: E731
    else:
        make = lambda model: DynamicEngine(model, EngineConfig(  # noqa: E731
            prefill_chunk=4, prefix_cache=True, **_ENG))
    prompts, lens = _mixed_prompts(m.tm.cfg.vocab_size)
    a = make(m.tm).serve(m.tp, prompts, lens)
    b = make(m.tm8).serve(m.tp, prompts, lens)
    assert torch.equal(a["lengths"], b["lengths"])
    valid = torch.arange(a["tokens"].shape[1])[None] < a["lengths"][:, None]
    agree = float((a["tokens"][valid] == b["tokens"][valid]).float().mean())
    assert agree >= 0.99, agree


def test_dynamic_int8_prefix_cache_carries_scales(models):
    """Shared and re-admitted pages carry their scales: the int8 dynamic
    engine with chunked prefill and the prefix cache, cold and then warm,
    gives the tokens of the one-shot engine with the cache off (the
    reference's test_dynamic_int8_prefix_cache_carries_scales)."""
    from repro_torch.serving.engine import DynamicEngine, EngineConfig

    m = models
    on = DynamicEngine(m.tm8, EngineConfig(prefill_chunk=4, prefix_cache=True, **_ENG))
    off = DynamicEngine(m.tm8, EngineConfig(**_ENG))
    prompts, lens = _shared_prefix_prompts(m.tm.cfg.vocab_size)
    want = off.serve(m.tp, prompts, lens)
    g1 = on.serve(m.tp, prompts, lens)
    g2 = on.serve(m.tp, prompts, lens)
    for got in (g1, g2):
        assert torch.equal(got["tokens"], want["tokens"])
    assert 0 < g1["prefill_cached"] < g2["prefill_cached"]
    on.blocks.check_invariants()


def test_dynamic_int8_eviction_readmission(models):
    """Near-zero cache headroom forces LRU eviction on most admissions;
    requantized re-admissions still give the one-shot cache-off engine's
    tokens (the reference's test_dynamic_int8_eviction_readmission)."""
    from repro_torch.serving.engine import DynamicEngine, EngineConfig

    m = models
    spec = tkv.build_spec(m.tm8.cfg, _ENG["n_slots"],
                          _ENG["max_prompt_len"] + _ENG["max_gen_len"], _ENG["page_size"])
    n_pages = 2 * spec.gp_cols + 2
    on = DynamicEngine(m.tm8, EngineConfig(prefill_chunk=4, prefix_cache=True,
                                           n_pages=n_pages, **_ENG))
    off = DynamicEngine(m.tm8, EngineConfig(n_pages=n_pages, **_ENG))
    rng = np.random.default_rng(31)
    prompts = rng.integers(0, m.tm.cfg.vocab_size, (6, 16)).astype(np.int32)
    lens = np.full(6, 16, np.int32)
    assert torch.equal(on.serve(m.tp, prompts, lens)["tokens"],
                       off.serve(m.tp, prompts, lens)["tokens"])
    on.blocks.check_invariants()


# ---------------------------------------------------------------------------
# on the card: the CUDA int8 modes against their plain versions
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("K,G,window,softcap", DECODE_CASES)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_int8_decode_kernel_matches_plain_on_card(K, G, window, softcap, q_dtype):
    _need_card()
    args, scales = _int8_args(paged_case(3, K, G, 64, 16, 6, [81, 0, 13], dead=((1, 0),)))
    dt = getattr(torch, q_dtype)
    args = [a.cuda() for a in (args[0][:, 0].to(dt), *args[1:5], args[5][:, 0])]
    scales = {n: s.cuda() for n, s in scales.items()}
    kw = dict(scale=0.125, window=window, softcap=softcap, **scales)
    n0 = da.int8_launches
    got = ops.decode_attention(*args, impl="kernel", **kw)
    assert da.int8_launches == n0 + 1
    want = ops.decode_attention(*args, impl="ref", **kw)
    atol = TIGHT if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.count_nonzero(got[1]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("K,G,window,softcap,T", MULTI_CASES)
def test_int8_multi_kernel_matches_plain_on_card(K, G, window, softcap, T):
    _need_card()
    args, scales = _int8_args(paged_case(2, K, G, 64, 16, 6, [9, 40], T=T,
                                         dead=((1, T - 1),), seed=1))
    args = [a.cuda() for a in args]
    kw = dict(scale=0.125, window=window, softcap=softcap,
              **{n: s.cuda() for n, s in scales.items()})
    n0 = da.multi_int8_launches
    got = ops.decode_attention_multi(*args, impl="kernel", **kw)
    assert da.multi_int8_launches == n0 + 1
    want = ops.decode_attention_multi(*args, impl="ref", **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=TIGHT)
    assert torch.count_nonzero(got[1, T - 1]) == 0


@pytest.mark.gpu
def test_int8_kernel_cases_of_the_chip_smoke():
    """chip_smoke.py's int8 B8 and B9 cases."""
    _need_card()
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.check_int8_decode_cases(ops)
    smoke.check_int8_multi_cases(ops, da)
