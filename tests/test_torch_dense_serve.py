"""The dense-loop serve driver in the port against the reference: ``generate``
(a prefill, then one ``Model.decode_step`` a token over a dense cache) on
mamba2's ``ssd`` stack, smollm's global attention, gemma2's sliding-window
ring, mixtral's MoE layers and recurrentgemma's RG-LRU groups and tail; its cache layout (``cache_shapes`` /
``init_cache``); the port's dense driver against its static engine; the
temperature draws; and the serve CLI's fallback and ``--dense``.

On the reference's smokes in f32 with a random query projection and a
random readout where the config zero-inits them (``zero_init_query=False``,
``zero_init_readout=False``): with a zero readout every logit is 0 and
greedy decoding emits token 0 everywhere, which any driver would match.
The reference's weights move over by ``convert.params_from_numpy``;
prompts are drawn with numpy from fixed seeds.  Greedy tokens are held
token for token.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig  # noqa: E402

ARCHS = ["mamba2-130m", "smollm-135m", "gemma2-2b", "mixtral-8x22b", "recurrentgemma-9b"]
OVER = dict(dtype="float32", zero_init_query=False, zero_init_readout=False)
# prompts of one SSD chunk (16), 12 generated: gemma2's, mixtral's and
# recurrentgemma's windows of 8 wrap their rings while decoding
P, GEN = 16, 12

_MODELS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    """(reference model, its params, port model, the same params)."""
    if arch not in _MODELS:
        jm = jbuild(j_smoke(arch, **OVER))
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (jm, jp, tbuild(t_smoke(arch, **OVER), device="cpu"), tp)
    return _MODELS[arch]


def _prompts(V, R=3, seed=1):
    return np.random.default_rng(seed).integers(0, V, (R, P)).astype(np.int32)


def _both(arch, prompts, **kw):
    jm, jp, tm, tp = _models(arch)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompts), GEN, **kw))
    got = tserve.generate(tm, tp, prompts, GEN, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference(arch):
    """Greedy generate token for token: with no stop token; with a stop
    token one row emits early (the rows after it padded with it, the others
    decoding on); and on that row alone, where the loop stops early and pads
    the rest.  _count_generated equal on every output."""
    jm = _models(arch)[0]
    prompts = _prompts(jm.cfg.vocab_size)
    got, want = _both(arch, prompts)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1
    eos = int(want[0, 2])
    stop = int(np.argmax(want[0] == eos))
    for rows in (prompts, prompts[:1]):
        got, want = _both(arch, rows, eos_token_id=eos)
        np.testing.assert_array_equal(got, want)
        assert (want[0, stop:] == eos).all()
        assert tserve._count_generated(torch.from_numpy(got), eos) == \
            jserve._count_generated(want, eos)
    assert tserve._count_generated(torch.from_numpy(got), eos) == stop + 1
    assert tserve._count_generated(torch.from_numpy(got), -1) == GEN


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_the_reference(arch):
    """cache_shapes equals the reference's whole layout, {"groups", "tail"}
    (shapes and dtypes: ring lengths for windowed layers, h in f32 and the
    conv state in the activation dtype for ssd and recurrent ones, the
    tail's unstacked; an empty tail where the config has none); init_cache
    is empty (positions -1) and prefill emits the same layout."""
    jm, jp, tm, tp = _models(arch)
    want = jax.tree_util.tree_map(
        lambda sd: (tuple(sd[0]), str(jnp.dtype(sd[1]))),
        jm.cache_shapes(2, P + GEN),
        is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    shapes = tm.cache_shapes(2, P + GEN)
    assert sorted(shapes) == sorted(want) == ["groups", "tail"]
    for part in ("groups", "tail"):
        got = {k: {n: (tuple(s), str(d).replace("torch.", "")) for n, (s, d) in
                   _leaves(v).items()} for k, v in shapes[part].items()}
        assert got == {k: _leaves(v) for k, v in want[part].items()}, part
    assert bool(shapes["tail"]) == bool(tm.cfg.tail)
    cache = tm.init_cache(2, P + GEN)
    for name, t in _leaves(cache).items():
        assert t.dtype != torch.int32 or bool((t == -1).all()), name
        assert t.dtype == torch.int32 or not t.any(), name
    _, pc = tm.prefill(tp, torch.from_numpy(_prompts(tm.cfg.vocab_size, 2)).long(),
                       cache_len=P + GEN)
    assert ({n: (tuple(t.shape), t.dtype) for n, t in _leaves(pc).items()}
            == {n: (tuple(t.shape), t.dtype) for n, t in _leaves(cache).items()})


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b"])
def test_dense_driver_matches_the_static_engine(arch):
    """The port's dense driver against its static engine (the paged pools,
    B8 and B9's plain versions here) on full-length prompts: the same greedy
    tokens, token for token, as the reference's oracle test holds its own
    engine."""
    _, _, tm, tp = _models(arch)
    prompts = _prompts(tm.cfg.vocab_size, R=4, seed=3)
    dense = tserve.generate(tm, tp, prompts, GEN)
    ecfg = EngineConfig(n_slots=2, page_size=4, max_prompt_len=P, max_gen_len=GEN)
    out = Engine(tm, ecfg).serve(tp, prompts, np.full(4, P))
    assert (np.asarray(out["lengths"]) == GEN).all()
    np.testing.assert_array_equal(np.asarray(out["tokens"]), dense.numpy())


def test_sampled_generate_is_a_function_of_seed_position_and_row():
    """With a temperature each draw comes from the engines' counter-based
    hash of (seed, input position, row): the same seed gives the same tokens
    twice and the static engine's tokens on the same requests; another seed
    other tokens."""
    _, _, tm, tp = _models("smollm-135m")
    prompts = _prompts(tm.cfg.vocab_size, R=4, seed=4)
    a = tserve.generate(tm, tp, prompts, GEN, temperature=1.0, seed=5)
    b = tserve.generate(tm, tp, prompts, GEN, temperature=1.0, seed=5)
    c = tserve.generate(tm, tp, prompts, GEN, temperature=1.0, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = tserve.generate(tm, tp, prompts, GEN)
    assert not torch.equal(a, greedy)
    ecfg = EngineConfig(n_slots=2, page_size=4, max_prompt_len=P, max_gen_len=GEN)
    out = Engine(tm, ecfg).serve(tp, prompts, np.full(4, P),
                                 temperature=torch.full((4,), 1.0), seed=5)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), a.numpy())


def test_engines_refuse_mamba2_like_the_reference():
    """Both engines refuse an ssd pattern, naming paged serving and the
    dense-loop driver, as the reference's engine does."""
    jm, _, tm, _ = _models("mamba2-130m")
    for cls in (Engine, DynamicEngine):
        with pytest.raises(ValueError, match="paged serving.*dense-loop driver"):
            cls(tm, EngineConfig(n_slots=2, page_size=4, max_prompt_len=P,
                                 max_gen_len=GEN))
    with pytest.raises(ValueError, match="paged serving"):
        JEngine(jm, JEngineConfig(n_slots=2, page_size=4, max_prompt_len=P,
                                  max_gen_len=GEN))


def test_engines_refuse_recurrentgemma_like_the_reference():
    """Both engines refuse recurrentgemma's recurrent blocks, as the
    reference's engine does; the paged decode path refuses a tail, which
    the paged pools do not hold."""
    jm, _, tm, tp = _models("recurrentgemma-9b")
    for cls in (Engine, DynamicEngine):
        with pytest.raises(ValueError, match="paged serving.*dense-loop driver"):
            cls(tm, EngineConfig(n_slots=2, page_size=4, max_prompt_len=P,
                                 max_gen_len=GEN))
    with pytest.raises(ValueError, match="paged serving"):
        JEngine(jm, JEngineConfig(n_slots=2, page_size=4, max_prompt_len=P,
                                  max_gen_len=GEN))
    with pytest.raises(NotImplementedError, match="dense-loop driver"):
        tm.forward(tp, torch.zeros((1, 1), dtype=torch.long),
                   positions=torch.zeros((1, 1), dtype=torch.int32), mode="decode",
                   cache={}, paged=object())


def _lines(text, starts):
    return [ln for ln in text.splitlines() if ln.startswith(starts)]


@pytest.mark.parametrize("arch,extra", [("mamba2-130m", []),
                                        ("gemma2-2b", ["--dense"]),
                                        ("recurrentgemma-9b", [])],
                         ids=["mamba2_fallback", "gemma2_dense",
                              "recurrentgemma_fallback"])
def test_serve_cli_prints_the_reference_lines(arch, extra, capsys):
    """The serve CLI on a smoke: mamba2 and recurrentgemma fall back to the
    dense driver with the reference's line, --dense forces it on gemma2; the ignored flags'
    messages and the [serve:dense] line's shape and count are the
    reference's (its time and tokens aside: each package draws its own
    weights and prompts)."""
    argv = ["--arch", arch, "--smoke", "--requests", "2", "--prompt-len", "32",
            "--gen-len", "8", "--mixed-lens", "--top-k", "4", "--draft-width",
            "0.5", *extra]
    jserve.main(argv)
    ref = capsys.readouterr().out
    toks = tserve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert tuple(toks.shape) == (2, 8)
    said = ("[serve] ", )
    assert _lines(out, said) == _lines(ref, said) and _lines(ref, said)
    if not extra:
        assert "not paged-servable yet; falling back to the dense-loop driver" in out
    ours = _lines(out, "[serve:dense]")
    theirs = _lines(ref, "[serve:dense]")
    assert len(ours) == len(theirs) == 1
    assert ours[0].split(" in ")[0] == theirs[0].split(" in ")[0] \
        == "[serve:dense] generated (2, 8) (16 tokens)"
