"""The port's serving path against the reference: paged-cache writes and
admission, sampling filters, and the static engine end to end.

Greedy serving must match the reference token for token, with the same
lengths and loop-iteration count.  Sampled serving cannot match draw for
draw (torch cannot replay ``jax.random``), so the sampler is held to the
reference by its keep masks and by its empirical distribution.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import sampling as tsampling  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

def _cfgs():
    over = dict(dtype="float32", zero_init_query=False)
    return j_smoke("smollm-135m", **over), t_smoke("smollm-135m", **over)


def _pools_pair(jcfg, tcfg, S, max_total, P, seed):
    """Reference and port pools holding the same random stale bytes."""
    jspec = jkv.build_spec(jcfg, S, max_total, P)
    tspec = tkv.build_spec(tcfg, S, max_total, P)
    jpools = jkv.init_pools(jcfg, jspec)
    tpools = tkv.init_pools(tcfg, tspec, "cpu")
    rng = np.random.default_rng(seed)
    for key, jp in jpools["groups"].items():
        for leaf in ("k", "v"):
            a = rng.standard_normal(jp["attn"][leaf].shape).astype(np.float32)
            jp["attn"][leaf] = jnp.asarray(a)
            tpools["groups"][key]["attn"][leaf].copy_(torch.from_numpy(a))
    return jspec, tspec, jpools, tpools


def _assert_pool_equal(jpool, tpool):
    jpos = np.asarray(jpool["pos"])
    np.testing.assert_array_equal(tpool["pos"].numpy(), jpos)
    live = jpos >= 0
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(tpool[leaf].numpy()[live],
                                      np.asarray(jpool[leaf])[live])


def test_paged_cache_write_matches_reference():
    """Active, inactive, negative and past-budget positions in one write."""
    jcfg, tcfg = _cfgs()
    S, P = 4, 4
    jspec, tspec, jpools, tpools = _pools_pair(jcfg, tcfg, S, 12, P, seed=0)
    jtab, _ = jkv.make_tables(jspec)
    ttab = tkv.make_tables(tspec, "cpu")
    jpool = jax.tree_util.tree_map(lambda a: a[0], jpools["groups"]["0_attn"]["attn"])
    tpool = {k: v[0] for k, v in tpools["groups"]["0_attn"]["attn"].items()}
    rng = np.random.default_rng(1)
    K, hd = jcfg.n_kv_heads, jcfg.d_head
    for positions, active in (
        ([[0], [5], [11], [3]], [True, True, True, False]),
        ([[1], [-1], [12], [6]], [True, True, True, True]),  # -1, past budget
    ):
        positions = np.asarray(positions, np.int32)
        k = rng.standard_normal((S, 1, K, hd)).astype(np.float32)
        v = rng.standard_normal((S, 1, K, hd)).astype(np.float32)
        jpool = jkv.paged_cache_write(
            jpool, jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
            jtab, jnp.asarray(active), P, ring=False,
        )
        tkv.paged_cache_write(
            tpool, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(positions), ttab, torch.as_tensor(active), P,
        )
        _assert_pool_equal(jpool, tpool)


def test_admit_slot_matches_reference_and_resets_the_slot():
    """Admitting into a slot that held an earlier, longer request leaves only
    the new prompt's positions visible; padding is dropped."""
    jcfg, tcfg = _cfgs()
    S, P, Pmax = 2, 4, 12
    jspec, tspec, jpools, tpools = _pools_pair(jcfg, tcfg, S, Pmax + 4, P, seed=2)
    jtab, _ = jkv.make_tables(jspec)
    ttab = tkv.make_tables(tspec, "cpu")
    L, K, hd = jcfg.n_groups, jcfg.n_kv_heads, jcfg.d_head
    rng = np.random.default_rng(3)
    for slot, plen in ((1, 11), (0, 7), (1, 5)):
        k = rng.standard_normal((L, 1, Pmax, K, hd)).astype(np.float32)
        v = rng.standard_normal((L, 1, Pmax, K, hd)).astype(np.float32)
        pos = np.broadcast_to(np.where(np.arange(Pmax) < plen, np.arange(Pmax), -1),
                              (L, 1, Pmax)).astype(np.int32)
        pc = {"k": k, "v": v, "pos": pos}
        jpools = jkv.admit_slot(
            jpools, {"groups": {"0_attn": {"attn": {n: jnp.asarray(a) for n, a in pc.items()}}},
                     "tail": {}},
            jcfg, jspec, jtab[slot], None, jnp.int32(plen),
        )
        tkv.admit_slot(
            tpools, {"groups": {"0_attn": {"attn": {n: torch.from_numpy(a) for n, a in pc.items()}}}},
            tcfg, tspec, ttab[slot], plen,
        )
        _assert_pool_equal(jpools["groups"]["0_attn"]["attn"],
                           tpools["groups"]["0_attn"]["attn"])
    slot1 = tpools["groups"]["0_attn"]["attn"]["pos"][:, ttab[1].long()]
    assert sorted(slot1[0][slot1[0] >= 0].tolist()) == list(range(5))


def test_non_attn_blocks_are_refused():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="not ported"):
        tkv.check_servable(tcfg.replace(pattern=("local",)))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

SAMPLING_PARAMS = (                     # (temperature, top_k, top_p) per row
    [0.0, 1.0, 0.7, 1.3, 0.9, 1.0],
    [0, 5, 0, 40, 3, 1],
    [1.0, 1.0, 0.8, 0.5, 0.95, 1.0],
)


def test_keep_masks_match_reference_thresholds():
    rng = np.random.default_rng(4)
    logits = (2.0 * rng.standard_normal((6, 300))).astype(np.float32)
    temp, tk, tp = (np.asarray(a, dt) for a, dt in
                    zip(SAMPLING_PARAMS, (np.float32, np.int32, np.float32)))
    keep, _ = tsampling.keep_mask(torch.from_numpy(logits), torch.from_numpy(temp),
                                  torch.from_numpy(tk), torch.from_numpy(tp))
    scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None]
    tau_k, tau_p = jax.vmap(jsampling._filter_thresholds)(
        scaled, jnp.asarray(tk), jnp.asarray(tp))
    want = (scaled > jnp.maximum(tau_k, tau_p)[:, None]) | (
        scaled == jnp.max(scaled, axis=-1, keepdims=True))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    assert keep[5].sum() == 1 and keep[1].sum() == 5 and keep[4].sum() == 3


def test_sample_greedy_support_and_determinism():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((2.0 * rng.standard_normal((6, 300))).astype(np.float32))
    temp, tk, tp = (torch.as_tensor(a) for a in SAMPLING_PARAMS)
    tk = tk.to(torch.int32)
    keep, _ = tsampling.keep_mask(logits, temp, tk, tp)
    for pos in range(20):
        keys = tsampling.event_key(7, torch.full((6,), pos), torch.arange(6), 0, "cpu")
        tok = tsampling.sample(logits, temp, tk, tp, keys).long()
        assert tok[0] == logits[0].argmax()                  # greedy row
        assert keep[torch.arange(6), tok].all()              # inside the support
        again = tsampling.sample(logits, temp, tk, tp, keys)
        assert torch.equal(tok.int(), again)                 # pure function of keys
        one = tsampling.sample_token(logits[3], temp[3], tk[3], tp[3], keys[3])
        assert one == tok[3]


def test_sample_distribution_matches_reference():
    """Gumbel-max over the filtered logits draws from the reference's
    filtered distribution: empirical frequencies over 4000 events."""
    logits = np.array([[2.0, 1.5, 1.0, 0.5, 0.0, -1.0, -3.0, 0.2]], np.float32)
    temp, tk, tp = np.float32([0.8]), np.int32([5]), np.float32([0.9])
    want = np.asarray(jsampling.filtered_dist(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(tk), jnp.asarray(tp)))[0]
    n = 4000
    keys = tsampling.event_key(11, torch.arange(n), 0, 0, "cpu")
    tok = tsampling.sample(
        torch.from_numpy(logits).expand(n, -1), torch.from_numpy(temp).expand(n),
        torch.from_numpy(tk).expand(n), torch.from_numpy(tp).expand(n), keys,
    )
    freq = np.bincount(tok.numpy(), minlength=8) / n
    assert np.all(freq[want == 0] == 0)
    np.testing.assert_allclose(freq, want, atol=4 * np.sqrt(0.25 / n))


# ---------------------------------------------------------------------------
# the static engine end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """Reference and port models on the same weights, and a workload with
    more requests than slots and mixed prompt lengths."""
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, jcfg.vocab_size, (5, 16)).astype(np.int32)
    lens = np.array([16, 3, 9, 1, 12], np.int32)
    return jm, jp, tm, tp, prompts, lens


def _serve_both(served, eos):
    jm, jp, tm, tp, prompts, lens = served
    kw = dict(n_slots=2, page_size=4, max_prompt_len=16, max_gen_len=6,
              eos_token_id=eos)
    want = JEngine(jm, JEngineConfig(**kw)).serve(jp, prompts, lens)
    got = Engine(tm, EngineConfig(**kw)).serve(tp, prompts, lens)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert got["steps"] == int(want["steps"])
    return got


@pytest.mark.parametrize("with_eos", [False, True])
def test_engine_greedy_matches_reference_engine(served, with_eos):
    """Greedy tokens, lengths and steps identical to the reference engine;
    with an EOS taken from the plain run's output, requests retire early."""
    eos = -1
    if with_eos:
        jm, jp, tm, tp, prompts, lens = served
        plain = Engine(tm, EngineConfig(n_slots=2, page_size=4, max_prompt_len=16,
                                        max_gen_len=6)).serve(tp, prompts, lens)
        row = plain["tokens"][0].tolist()
        eos = row[2]                 # request 0 stops by its 3rd token
    got = _serve_both(served, eos)
    if with_eos:
        assert got["lengths"][0] == row.index(eos) + 1


def test_serve_cli_on_cpu_and_unported_flags():
    toks = tserve.main(["--smoke", "--device", "cpu", "--requests", "3",
                        "--prompt-len", "8", "--gen-len", "4", "--slots", "2",
                        "--page-size", "4", "--mixed-lens"])
    assert tuple(toks.shape) == (3, 4)
    for flag in (["--dense"], ["--kv-dtype", "int8"], ["--prefix-cache"],
                 ["--draft-width", "0.25"], ["--mesh", "1,2"], ["--obs"]):
        with pytest.raises(SystemExit):
            tserve.main(["--smoke", "--device", "cpu", *flag])
