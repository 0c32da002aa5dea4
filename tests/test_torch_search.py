"""The port's random search and its legacy single-candidate paths, against
the reference: ``core.tuning.random_search`` (batched, serial, and with an
``eval_fn``), ``core.tuning.train_proxy``, the ``SearchSpace`` and
``Parametrization`` shims, and ``core.transfer.reverse_transfer``.

The port's init draws from ``torch.Generator``s, which cannot replay
JAX's PRNG: the trained paths are held against the reference on its own
init, carried across by ``params_from_numpy`` (the reference's
``Model.init(PRNGKey(seed))`` for ``train_proxy``, its ``init_params`` at
``candidate_rngs(seed, n)[i]`` for the batched engine), and the same
batches, at rtol 2e-3 (the reference's batched-against-serial tolerance).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import hpspace as jhpspace  # noqa: E402
from repro.core import parametrization as jparam  # noqa: E402
from repro.core import transfer as jtransfer  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.core.init import init_params as jinit_params  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import hpspace as thpspace  # noqa: E402
from repro_torch.core import parametrization as tparam  # noqa: E402
from repro_torch.core import transfer as ttransfer  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

SWEEP_RTOL = 2e-3           # the reference's batched-vs-serial tolerance
KW = dict(batch_size=4, seq_len=32)


@pytest.fixture(scope="module", autouse=True)
def _threefry_as_written_and_one_thread():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(n)


def _fields(h):
    return {f.name: getattr(h, f.name) for f in dataclasses.fields(h)}


def _reference_cfg(cfg):
    """The reference's ModelConfig with every field the port's has."""
    return jsmoke("mup-gpt").replace(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture
def reference_init(monkeypatch):
    """The port's inits replaced by the reference's: ``Model.init(seed)``
    by the reference's ``Model.init(PRNGKey(seed))`` on the same config,
    and the batched engine's default init by ``init_params`` at
    ``candidate_rngs(0, n)[i]`` with candidate i's sigma."""
    def model_init(self, seed=0, dtype=torch.float32):
        jparams = jbuild(_reference_cfg(self.cfg)).init(jax.random.PRNGKey(seed))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 device=self.device)

    def default_init(model):
        jmodel = jbuild(_reference_cfg(model.cfg))

        def init(gens, hp):
            sigmas = jnp.asarray(hp.sigma.cpu().numpy(), jnp.float32)
            stacked = jax.vmap(
                lambda r, s: jinit_params(r, jmodel.meta, jmodel.p13n, sigma=s))(
                jtuning.candidate_rngs(0, len(gens)), sigmas)
            flat = flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                                lambda x: isinstance(x, np.ndarray))
            return params_from_numpy(flat, device=model.device)
        return init

    monkeypatch.setattr(tmodel.Model, "init", model_init)
    monkeypatch.setattr(ttuning, "_default_init", default_init)


def _same_scores(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=SWEEP_RTOL)


def _same_search(got, want):
    (gbest, gtrials), (wbest, wtrials) = got, want
    assert [_fields(h) for h, _ in gtrials] == [_fields(h) for h, _ in wtrials]
    _same_scores([s for _, s in gtrials], [s for _, s in wtrials])
    assert _fields(gbest) == _fields(wbest)


# ---------------------------------------------------------------------------
# train_proxy, the legacy single-candidate path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hp", [dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
                                dict(lr=2e-2, alpha_attn=2.0, alpha_embed=0.5,
                                     lr_embed=5e-3),
                                dict(lr=1e25)])
def test_train_proxy_matches_reference(reference_init, hp):
    hps = thpspace.mup_space().hparams(**hp)
    got = ttuning.train_proxy(tsmoke("mup-gpt"), hps, steps=4, seed=1, device="cpu", **KW)
    want = jtuning.train_proxy(jsmoke("mup-gpt"), hps, steps=4, seed=1, **KW)
    _same_scores([got], [want])
    assert math.isinf(got) == (hp["lr"] > 1.0)


def test_train_proxy_refusals(reference_init):
    """A fixed axis is refused; cfg.amp is not: train_proxy under bf16
    matches the reference's on its init."""
    space = thpspace.umup_space()
    with pytest.raises(ValueError, match="fixed at 1.0"):
        ttuning.train_proxy(tsmoke("mup-gpt").replace(parametrization="umup"),
                            space.hparams(sigma=0.5), steps=1, device="cpu", **KW)
    hps = thpspace.mup_space().hparams(lr=1e-2)
    got = ttuning.train_proxy(tsmoke("mup-gpt").replace(amp="bf16"), hps, steps=2,
                              device="cpu", **KW)
    want = jtuning.train_proxy(jsmoke("mup-gpt").replace(amp="bf16"), hps, steps=2, **KW)
    _same_scores([got], [want])


# ---------------------------------------------------------------------------
# random_search: batched, serial, eval_fn
# ---------------------------------------------------------------------------

def test_random_search_batched_matches_reference(reference_init):
    got = ttuning.random_search(tsmoke("mup-gpt"), n_samples=4, steps=4, seed=0,
                                device="cpu", **KW)
    want = jtuning.random_search(jsmoke("mup-gpt"), n_samples=4, steps=4, seed=0, **KW)
    _same_search(got, want)
    # the batched search is train_proxy_batched over the space's own draws
    samples = [h for h, _ in got[1]]
    assert [_fields(h) for h in samples] == \
        [_fields(h) for h in thpspace.mup_space().sample_n(4, seed=0)]


def test_random_search_serial_matches_reference(reference_init):
    """batched=False: trial i trains alone on data seed ``seed + i``."""
    space = ttuning.SearchSpace(thpspace.mup_space(), lr=(1e-3, 1e-2))
    jspace = jtuning.SearchSpace(jhpspace.mup_space(), lr=(1e-3, 1e-2))
    got = ttuning.random_search(tsmoke("mup-gpt"), n_samples=2, space=space, steps=3,
                                seed=2, batched=False, device="cpu", **KW)
    want = jtuning.random_search(jsmoke("mup-gpt"), n_samples=2, space=jspace, steps=3,
                                 seed=2, batched=False, **KW)
    _same_search(got, want)


@pytest.mark.parametrize("space", ["mup", "umup"])
def test_random_search_eval_fn_matches_reference(space):
    """eval_fn scores each draw; the draws, scores and best equal the
    reference's exactly, and the default space follows the proxy's
    parametrization (u-µP sweeps no sigma)."""
    def score(h):
        return abs(math.log(h.lr / 1e-2)) + abs(math.log(h.sigma)) + h.alpha_output

    cfg = tsmoke("mup-gpt").replace(parametrization=space)
    got = ttuning.random_search(cfg, n_samples=8, seed=5, eval_fn=score, device="cpu")
    want = jtuning.random_search(_reference_cfg(cfg), n_samples=8, seed=5, eval_fn=score)
    assert [(_fields(h), s) for h, s in got[1]] == [(_fields(h), s) for h, s in want[1]]
    assert _fields(got[0]) == _fields(want[0])
    if space == "umup":
        assert {h.sigma for h, _ in got[1]} == {1.0}
    shim = ttuning.SearchSpace(lr=(1e-3, 1e-2))
    jshim = jtuning.SearchSpace(lr=(1e-3, 1e-2))
    assert shim.lr == jshim.lr and shim.sigma == jshim.sigma
    assert [_fields(h) for h in shim.sample_n(4, 3)] == [_fields(h) for h in jshim.sample_n(4, 3)]
    rng_t, rng_j = np.random.RandomState(1), np.random.RandomState(1)
    assert _fields(shim.sample(rng_t)) == _fields(jshim.sample(rng_j))
    with pytest.raises(AttributeError):
        shim.nope


# ---------------------------------------------------------------------------
# reverse_transfer and the Parametrization shim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mup-gpt", "smollm-135m"])
@pytest.mark.parametrize("narrow", [128, 256])
def test_reverse_transfer_matches_reference(arch, narrow):
    hps = thpspace.mup_space().hparams(lr=3e-3)
    got = ttransfer.reverse_transfer(hps, tconfig(arch), narrow)
    want = jtransfer.reverse_transfer(hps, jconfig(arch), narrow)
    assert {f.name: getattr(want, f.name) for f in dataclasses.fields(got)} == \
        dataclasses.asdict(got)
    assert got.d_model == narrow and got.name.endswith(f"@simwidth{tconfig(arch).d_model}")
    # the base shape stays the wide model's: the narrow model simulates it
    assert got.base_d_model == tconfig(arch).base_d_model


SHIM_NAMES = ("SP", "MUP", "MUP_TABLE3", "MUP_TABLE9", "NTK", "UMUP")


def test_parametrization_shim_matches_reference():
    # the built-in rules lead both registries in the same order; other
    # tests in the same process may register more behind them
    n = len(SHIM_NAMES)
    assert [str(p) for p in tparam.Parametrization][:n] == \
        [str(p) for p in jparam.Parametrization][:n]
    assert [type(p).__name__ for p in tparam.Parametrization][:n] == \
        [type(p).__name__ for p in jparam.Parametrization][:n]
    for name in SHIM_NAMES:
        got, want = getattr(tparam.Parametrization, name), getattr(jparam.Parametrization, name)
        assert str(got) == str(want) and type(got).__name__ == type(want).__name__
        assert got is tparam.resolve(str(got))
    for alias in ("mup", "sp", "umup"):
        assert tparam.Parametrization(alias) is tparam.resolve(alias)
        assert str(tparam.Parametrization(alias)) == str(jparam.Parametrization(alias))
