"""The port's coordinate check (``repro_torch.core.coord_check``) against the
reference's (``repro.core.coord_check``): live, on the same factory,
widths, batches and weights, and against the reference's committed goldens
(``tests/golden/coord_check.json``); and the paper's claim that licenses
int8 amp, u-µP's coord check staying flat under it (the reference's
``tests/test_quant.py::test_umup_coord_check_flat_under_int8_amp``).

The goldens were written with ``jax_threefry_partitionable=False``, which
jax 0.9 no longer defaults to (the reason the reference's own
``test_coord_golden`` fails here); these tests init the reference with the
flag set to False and put it back after.  Tolerances are the golden test's,
RTOL 5e-3 / ATOL 1e-6 (measured: the port within 7.1e-6 relative of the
goldens and 5.8e-5 of the reference live in f32; under int8 amp every
record within 1e-3 relative, but the reference's step-0 ``logits.delta``,
1.4e-7 where the port's is 0: the reference forms x_t and x_0 by two
differently compiled forwards).
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core.coord_check import _loglog_slope as jslope  # noqa: E402
from repro.core.coord_check import coord_check as jcoord_check  # noqa: E402
from repro.core.parametrization import resolve as jresolve  # noqa: E402
from repro.data.pipeline import make_pipeline  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.coord_check import CoordCheckResult, _loglog_slope, coord_check  # noqa: E402
from repro_torch.core.parametrization import resolve as tresolve  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

GOLDEN_PATH = Path(__file__).resolve().parent / "golden" / "coord_check.json"
PARAMETRIZATIONS = ("sp", "mup", "umup")
WIDTHS = (1.0, 4.0)          # tests/test_coord_golden.py's
STEPS, LR = 2, 1e-2
AMP_WIDTHS = (1.0, 2.0, 4.0)  # tests/test_quant.py's
RTOL, ATOL = 5e-3, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _threefry_as_written_and_one_thread():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(n)


def _factories(p13n, widths, amp="", embed_probe=True):
    """make_model(i) for the reference and for the port on the same config:
    the port's weights are the reference's init, carried across by name;
    the acts are the logits and, as the golden test logs them, the scaled
    embedding."""
    jbase = jsmoke("mup-gpt").replace(dtype="float32", n_layers=2,
                                      zero_init_readout=False, zero_init_query=False)
    # mup-gpt ties its embeddings, so zero_init_readout changes nothing there
    tbase = tsmoke("mup-gpt").replace(dtype="float32", n_layers=2, zero_init_query=False)

    def acts_of(model, params, batch):
        loss, acts = model.loss_fn(params, batch, collect_acts=True)
        if embed_probe:
            acts = dict(acts, embed=model._embed(params, batch["tokens"]))
        return loss, acts

    def jmake(i):
        model = jbuild(jbase.scaled(widths[i]).replace(parametrization=p13n, amp=amp))
        return (model.init(jax.random.PRNGKey(0)), model.meta,
                lambda p, b: acts_of(model, p, b))

    def tmake(i):
        jparams = jbuild(jbase.scaled(widths[i]).replace(
            parametrization=p13n, amp=amp)).init(jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                   device="cpu")
        model = tbuild(tbase.scaled(widths[i]).replace(parametrization=p13n, amp=amp),
                       device="cpu")
        return params, model.meta, lambda p, b: acts_of(model, p, b)

    return jmake, tmake


def _batches(steps):
    pipe = make_pipeline(256, 32, 8, seed=0)
    raw = [pipe.batch(t) for t in range(steps)]
    return ([{k: jnp.asarray(v) for k, v in b.items()} for b in raw],
            [{k: torch.from_numpy(v) for k, v in b.items()} for b in raw])


def _records(p13n, widths, steps, lr, amp="", embed_probe=True, reference=True):
    """(port, reference) records, keyed by width as the goldens are (the
    reference's None unless asked for)."""
    jmake, tmake = _factories(p13n, widths, amp, embed_probe)
    jb, tb = _batches(steps)
    kw = dict(widths=list(range(len(widths))), optimizer="adam", lr=lr)
    key = lambda recs: {str(int(64 * widths[i])): v for i, v in recs.items()}  # noqa: E731
    got = coord_check(tmake, batches=tb, parametrization=tresolve(p13n), **kw)
    if not reference:
        return key(got.records), None
    want = jcoord_check(jmake, batches=jb, parametrization=jresolve(p13n), **kw)
    return key(got.records), key({i: [{k: float(x) for k, x in step.items()} for step in s]
                                  for i, s in want.records.items()})


@pytest.fixture(scope="module")
def mup_records():
    return _records("mup", WIDTHS, STEPS, LR)


@pytest.fixture(scope="module")
def int8_records():
    return _records("umup", AMP_WIDTHS, 3, 2e-2, amp="int8", embed_probe=False)


def _assert_records_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for width in want:
        assert len(got[width]) == len(want[width]), (what, width)
        for t, (gstep, wstep) in enumerate(zip(got[width], want[width])):
            assert sorted(gstep) == sorted(wstep), (what, width, t)
            for act, w in wstep.items():
                np.testing.assert_allclose(gstep[act], w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} width={width} step={t} {act}")


def test_coord_check_matches_reference_live(mup_records):
    """µP (Table 8) at the golden widths: every record of every step."""
    got, want = mup_records
    _assert_records_close(got, want, "mup live")


@pytest.mark.parametrize("p13n", PARAMETRIZATIONS)
def test_coord_check_matches_golden(p13n, mup_records):
    """The three parametrizations of the goldens, from the reference's init
    with jax_threefry_partitionable=False."""
    golden = json.loads(GOLDEN_PATH.read_text())
    meta = golden["__meta__"]
    assert (meta["widths"], meta["steps"], meta["lr"]) == (list(WIDTHS), STEPS, LR)
    got = (mup_records[0] if p13n == "mup"
           else _records(p13n, WIDTHS, STEPS, LR, reference=False)[0])
    _assert_records_close(got, golden[p13n], f"{p13n} golden")


def test_int8_coord_check_matches_reference_live(int8_records):
    """u-µP under int8 amp, the reference's flat-check setting, live."""
    got, want = int8_records
    _assert_records_close(got, want, "umup int8 live")


def test_umup_coord_check_flat_under_int8_amp(int8_records):
    """The licensing claim: unit scaling keeps the matmul operands O(1), so
    scaled-int8 matmuls must not bring back width-dependent logit growth
    (the reference's bar: slope < 0.1); the logits stay finite."""
    got, _ = int8_records
    res = CoordCheckResult(records={int(w): recs for w, recs in got.items()})
    assert res.growth("logits.delta", t=-1) < 0.1
    assert all(math.isfinite(step["logits"]) for recs in got.values() for step in recs)


def test_growth_is_the_reference_slope():
    """_loglog_slope equals the reference's on the same numbers, and growth
    reads the step it is asked for.  The reference asks for float64, which
    jax without x64 turns into float32: rel 1e-6."""
    widths, ys = [64, 128, 256], [1.0, 1.9, 4.2]
    assert _loglog_slope(widths, ys) == pytest.approx(jslope(widths, ys), rel=1e-6)
    res = CoordCheckResult(records={w: [{"a": 1.0}, {"a": y}] for w, y in zip(widths, ys)})
    assert res.growth("a") == pytest.approx(jslope(widths, ys), rel=1e-6)
    assert res.growth("a", t=0) == 0.0
