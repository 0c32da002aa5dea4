"""The sliding window of the port against the reference, piece by piece:
the window mask, query-chunked attention with its kv band, the dense ring
cache, the ring geometry (``build_spec``'s ring pages, with the speculative
and chunked-prefill lookahead), and the paged ring pools: writes that wrap,
admission that keeps only the ring's reach, invalidation of window pages,
over float32 pools and int8 pools byte for byte.

Inputs are drawn with numpy from fixed seeds and fed to both sides.
Attention outputs at the f32 forward tier (atol 2e-5); positions, int8
bytes and scales exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

F32_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# masks and query-chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 5])
def test_make_mask_matches_reference(causal, window):
    rng = np.random.default_rng(window + 10 * causal)
    q_pos = rng.integers(-1, 20, (3, 7)).astype(np.int32)
    kv_pos = rng.integers(-1, 20, (3, 11)).astype(np.int32)
    got = tattn.make_mask(_t(q_pos), _t(kv_pos), causal, window)
    want = jattn.make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(B, S, H, K, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, d), (B, S, K, d), (B, S, K, d)))


@pytest.mark.parametrize("S,chunk,window,softcap", [
    (48, 16, 6, 0.0),      # banded: band 22 < 48
    (48, 16, 6, 5.0),      # banded, softcap
    (64, 16, 40, 0.0),     # window wider than the chunk: band 56 < 64
    (32, 16, 20, 0.0),     # band 36 >= T: not cut
    (48, 16, 0, 0.0),      # global layer: every chunk sees all keys
    (16, 16, 6, 0.0),      # one chunk: plain attention
])
def test_attend_chunked_matches_reference(S, chunk, window, softcap):
    q, k, v = _qkv(2, S, 4, 2, 8, seed=S + window)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    pos[1, S - 5:] = S          # right padding at Pmax, as the engine's prefill
    got = tattn.attend_chunked(_t(q), _t(k), _t(v), _t(pos), _t(pos), 0.3,
                               window=window, attn_softcap=softcap, chunk=chunk)
    want = jattn.attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(pos), 0.3, window=window,
                                attn_softcap=softcap, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("window", [0, 6, 40])
def test_attend_chunked_ragged_last_chunk(window):
    """A sequence that is no multiple of the chunk (the reference's scan
    cannot take one; the static engine's 6,400-token prompt buffer over
    chunks of 2,048 is one): the same output as one full-width attention."""
    S, chunk = 45, 16
    q, k, v = _qkv(1, S, 4, 2, 8, seed=window)
    pos = _t(np.arange(S, dtype=np.int32)[None])
    got = tattn.attend_chunked(_t(q), _t(k), _t(v), pos, pos, 0.3, window=window, chunk=chunk)
    want = tattn.attend(_t(q), _t(k), _t(v), tattn.make_mask(pos, pos, True, window), 0.3)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the dense ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,length", [(5, 8), (8, 8), (13, 8)])
def test_ring_cache_from_prefill_matches_reference(S, length):
    """A windowed layer's prefill cache keeps the last ``length`` tokens at
    pos % length; a later windowed write (a decode step) lands on the ring."""
    k, v = (np.random.default_rng(S).standard_normal((2, S, 2, 4)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    got = tattn.cache_from_prefill(_t(k), _t(v), _t(pos), length, torch.float32,
                                   windowed=True)
    want = jattn.cache_from_prefill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                    length, windowed=True, dtype=jnp.float32)
    kn = np.ones((2, 1, 2, 4), np.float32)
    step = np.asarray([[S], [S + 3]], np.int32)
    got = tattn.cache_write(got, _t(kn), _t(kn), _t(step), windowed=True)
    want = jattn.cache_write(want, jnp.asarray(kn), jnp.asarray(kn), jnp.asarray(step), True)
    for leaf in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(want[leaf]), err_msg=leaf)


# ---------------------------------------------------------------------------
# ring geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,lookahead,max_total,P", [
    (6, 0, 64, 4), (6, 4, 64, 4), (8, 3, 36, 4), (4096, 0, 6464, 16),
    (4096, 255, 6464, 16), (4096, 4, 6464, 16), (4096, 0, 512, 16), (6, 0, 8, 4),
])
def test_build_spec_and_tables_match_reference(window, lookahead, max_total, P):
    """Ring pages per slot (``ceil((window + lookahead) / P) + 1``, at most
    the global count) and the interleaved window table, as the reference's:
    gemma2-2b's 257 ring pages when serving, 273 with chunks of 256."""
    jcfg = j_smoke("gemma2-2b", window_size=window)
    tcfg = t_smoke("gemma2-2b", window_size=window)
    jspec = jkv.build_spec(jcfg, 3, max_total, P, lookahead=lookahead)
    tspec = tkv.build_spec(tcfg, 3, max_total, P, lookahead=lookahead)
    assert (tspec.gp_cols, tspec.wp_cols, tspec.n_window_pages) == \
        (jspec.gp_cols, jspec.wp_cols, jspec.n_window_pages)
    jg, jw = jkv.make_tables(jspec)
    tg, tw = tkv.make_tables(tspec, "cpu")
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tkv.pool_bytes(tcfg, tspec) == jkv.pool_bytes(jcfg, jspec)


def test_build_spec_lookahead_grows_ring():
    """The reference's test of the same name (tests/test_speculative.py):
    window 6 needs ceil(6/4)+1 = 3 ring pages; a write-ahead of 4 needs
    ceil(10/4)+1 = 4.  A config with no windowed layer has none."""
    cfg = t_smoke("gemma2-2b").replace(window_size=6)
    assert tkv.build_spec(cfg, 2, 64, 4).wp_cols == 3
    assert tkv.build_spec(cfg, 2, 64, 4, lookahead=4).wp_cols == 4
    assert tkv.build_spec(t_smoke("smollm-135m"), 2, 64, 4, lookahead=4).wp_cols == 0


# ---------------------------------------------------------------------------
# paged ring pools: writes, admission, invalidation
# ---------------------------------------------------------------------------

def _assert_pools_equal(jpools, tpools, what, exact=True):
    for key, tp in tpools["groups"].items():
        jp = jpools["groups"][key]["attn"]
        assert set(jp) == set(tp["attn"]), what
        live = np.asarray(jp["pos"]) >= 0
        for name, t in tp["attn"].items():
            got, want = t.numpy(), np.asarray(jp[name])
            if not exact and name in ("k", "v"):
                got, want = got[live], want[live]
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {key} {name}")


def _write_layers(jpools, tpools, key, k_new, v_new, positions, tab, active, P, ring):
    """paged_cache_write on every layer of one group in both frameworks: the
    reference on each layer's leaves, the port on views into its stack."""
    jpool, tpool = jpools["groups"][key]["attn"], tpools["groups"][key]["attn"]
    new = []
    for layer in range(tpool["k"].shape[0]):
        leaf = {n: t[layer] for n, t in jpool.items()}
        new.append(jkv.paged_cache_write(
            leaf, jnp.asarray(k_new[layer]), jnp.asarray(v_new[layer]),
            jnp.asarray(positions), jnp.asarray(tab), jnp.asarray(active), P, ring=ring))
        tkv.paged_cache_write({n: t[layer] for n, t in tpool.items()}, _t(k_new[layer]),
                              _t(v_new[layer]), _t(positions), _t(tab), _t(active), P,
                              ring=ring)
    jpools["groups"][key]["attn"] = {n: jnp.stack([c[n] for c in new]) for n in jpool}


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ring_pools_match_reference(kv_dtype):
    """gemma2's two pools (the local layers' ring, the global layers'
    pages) through one life: an admission past the ring's reach (only the
    last wp * P tokens kept, the first kept page holding two logical pages'
    tokens), decode writes that wrap the ring (an inactive slot, a token
    20x the page's absmax: its scale grows and the page requantizes), a
    chunk across the wrap with a row at -1, an invalidation of window pages
    (ids past the pool dropped) and a write into one.  After every step the
    port's positions equal the reference's, and so do the bytes and scales
    of the int8 pools (the f32 pools' k/v where an entry is live)."""
    over = dict(dtype="float32", window_size=6, kv_dtype=kv_dtype)
    jcfg, tcfg = j_smoke("gemma2-2b", **over), t_smoke("gemma2-2b", **over)
    P, S, max_total = 4, 2, 36
    jspec, tspec = jkv.build_spec(jcfg, S, max_total, P), tkv.build_spec(tcfg, S, max_total, P)
    assert tspec.wp_cols == 3
    jpools, tpools = jkv.init_pools(jcfg, jspec), tkv.init_pools(tcfg, tspec, "cpu")
    exact = kv_dtype == "int8"
    _assert_pools_equal(jpools, tpools, "init")
    gtab, wtab = (np.asarray(t) for t in tkv.make_tables(tspec, "cpu"))
    L, K, hd = tcfg.n_groups, tcfg.n_kv_heads, tcfg.d_head
    rng = np.random.default_rng(7)

    # admission of slot 1: a 15-token prompt out of a 16-token buffer; the
    # ring (12 positions) keeps tokens 3..14
    Pmax, plen = 16, 15
    src = {key: {n: (rng.standard_normal((L, 1, Pmax, K, hd))
                     * rng.uniform(0.05, 4, (L, 1, Pmax, K, 1))).astype(np.float32)
                 for n in ("k", "v")} for key in ("0_local", "1_attn")}
    jnew = jkv.admit_slot(
        jpools, {"groups": {key: {"attn": {n: jnp.asarray(a) for n, a in s.items()}}
                            for key, s in src.items()}, "tail": {}},
        jcfg, jspec, jnp.asarray(gtab[1]), jnp.asarray(wtab[1]), jnp.int32(plen))
    jpools = {"groups": jnew["groups"], "tail": {}}
    tkv.admit_slot(tpools, {"groups": {key: {"attn": {n: _t(a) for n, a in s.items()}}
                                       for key, s in src.items()}},
                   tcfg, tspec, _t(gtab[1]), plen, wtab_row=_t(wtab[1]))
    _assert_pools_equal(jpools, tpools, "admission", exact)
    ring = tpools["groups"]["0_local"]["attn"]["pos"][0, wtab[1]]
    assert sorted(ring[ring >= 0].tolist()) == list(range(3, 15))

    def step(what, B, T, positions, active, mag):
        for key, tab, is_ring in (("0_local", wtab, True), ("1_attn", gtab, False)):
            kn, vn = ((rng.standard_normal((L, B, T, K, hd)) * mag).astype(np.float32)
                      for _ in range(2))
            _write_layers(jpools, tpools, key, kn, vn, np.asarray(positions, np.int32),
                          tab[:B], np.asarray(active), P, is_ring)
        _assert_pools_equal(jpools, tpools, what, exact)

    step("decode, slot 0 inactive", 2, 1, [[0], [15]], [False, True], 0.5)
    step("decode, a large token", 2, 1, [[0], [16]], [False, True], 20.0)
    step("chunk across the wrap, last row at -1", 2, 5, [[0, 1, 2, 3, -1],
                                                         [17, 18, 19, 20, 21]],
         [True, True], 1.0)
    for p in range(22, 30):   # wraps the ring once more
        step(f"decode at {p}", 2, 1, [[4 + p - 22], [p]], [True, True], 1.5)
    ids_w = np.asarray([wtab[0, 1], wtab[1, 2], 99], np.int32)     # 99: past the pool
    ids_g = np.asarray([gtab[0, 0]], np.int32)
    jpools = {"groups": jkv.invalidate_pages(jpools, jcfg, jnp.asarray(ids_g),
                                             jnp.asarray(ids_w))["groups"], "tail": {}}
    tkv.invalidate_pages(tpools, tcfg, ids_g, ids_w)
    _assert_pools_equal(jpools, tpools, "invalidation", exact)
    step("first write into an invalidated ring page", 2, 1, [[12], [32]], [True, True], 0.2)


# ---------------------------------------------------------------------------
# B9's plan at gemma2-2b's chunk shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bytes", [4, 2, 1])
@pytest.mark.parametrize("C", [257, 273, 404])
def test_b9_plan_places_gemma2_chunks(kv_bytes, C):
    """A chunk of 256 at gemma2-2b's 8/4 heads of 256 over its rings and its
    global table: one page a slot in a ring of two, and where even that
    does not fit beside 64 rows (bf16 and int8 pools, whose raw bytes sit
    beside the f32 staging) fewer rows a tile, balanced; on both H100s."""
    from repro_torch.kernels import decode_attention as da

    for sms in (132, 114):
        plan = da.decode_multi_plan(1, 4, 256, 2, 256, 16, C, kv_bytes, sms)
        assert (plan.stage_pages, plan.slots) == (1, 2)
        assert plan.smem <= da.MAX_DYN_SMEM and plan.tq * 2 <= da.MULTI_MAX_ROWS
        assert plan.tiles == -(-256 // plan.tq) and plan.tq == -(-256 // plan.tiles)
        if kv_bytes == 4:
            assert plan.tq == 32                   # the balanced tile of 64 rows
        else:                                      # 64 rows fit at no split count
            assert 24 <= plan.tq < 32
            assert all(da.multi_smem_bytes(64, S, 1, 2, 256, 16, C, kv_bytes, 64 * plan.cv)
                       > da.MAX_DYN_SMEM for S in range(1, da.MAX_SPLITS + 1))
