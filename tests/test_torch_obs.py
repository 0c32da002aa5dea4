"""The port's observability (``repro_torch.obs``) against the reference's
(``repro.obs``): the metrics registry and its Prometheus text byte for
byte, the tracer's event schema, the telemetry's host pieces (flatten,
ring, drift detector and report, ``str`` included), the model's µP-health
statistics on the reference's weights, the telemetry train step, the drift
detector separating SP from µP / u-µP, ``train_loop(obs=)``, the train
CLI's ``--telemetry --obs-dir``, ``Experiment.train(obs=)`` and
``run_sweep(tracer=)``.  The engines' obs hooks are in
tests/test_torch_obs_serve.py.

Tolerances: activation statistics at the model-logits bar (atol = rtol =
1e-4), update-to-weight ratios at the gradient tier (atol 2e-4, rtol 1e-3),
the golden fixtures at their own rtol 5e-3 (inited with
``jax_threefry_partitionable=False``, as they were written).  The telemetry
step's loss and grad norm are held bit-equal to the port's plain step.
"""
import functools
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.launch import sweep as jsweep  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.optim.optimizer import Optimizer as JOptimizer  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import tuning as ttuning  # noqa: E402
from repro_torch.core.hpspace import mup_space  # noqa: E402
from repro_torch.core.meta import flatten_tree  # noqa: E402
from repro_torch.core.transfer import HParams  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.launch import sweep as tsweep  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_step  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.obs import telemetry as ttelemetry  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.optim.optimizer import Optimizer as TOptimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_PATH = ROOT / "tests" / "golden" / "coord_check.json"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
ACT_TOL = dict(atol=1e-4, rtol=1e-4)
U2W_TOL = dict(atol=2e-4, rtol=1e-3)
P13NS = ("sp", "mup", "umup")


@pytest.fixture(scope="module", autouse=True)
def _threefry_as_written_and_one_thread():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# metrics: the same call sequence, the same text
# ---------------------------------------------------------------------------

def _drive_registry(mod, seed):
    """A seeded sequence of registry calls: counters, gauges, histograms
    (scalar and bulk observes, a capped one, custom buckets), a prefixed
    registry; returns the registries."""
    rng = np.random.default_rng(seed)
    reg, pre = mod.MetricsRegistry(), mod.MetricsRegistry(prefix="serve_")
    for i in range(40):
        r = rng.integers(0, 6)
        if r == 0:
            reg.counter(f"c{rng.integers(0, 3)}_total", "a counter").inc(
                float(rng.integers(0, 5)))
        elif r == 1:
            reg.gauge(f"g{rng.integers(0, 3)}", "a gauge").set(float(rng.normal()))
        elif r == 2:
            g = reg.gauge("g_inc")
            g.inc(float(rng.exponential()))
            g.dec(0.5)
        elif r == 3:
            reg.histogram("lat_seconds", "latency").observe(float(rng.exponential(0.05)))
        elif r == 4:
            reg.histogram("lat_seconds", "latency").observe_many(rng.exponential(0.05, 17))
        else:
            pre.histogram("ttft_seconds", buckets=(0.01, 0.1, 1.0)).observe_many(
                list(rng.exponential(0.2, 5)))
    h = mod.Histogram("capped", max_samples=8)
    h.observe_many(rng.exponential(1.0, 30))
    for x in rng.exponential(1.0, 9):
        h.observe(float(x))
    reg._metrics["capped"] = h
    reg.counter("whole_total").inc(2 ** 53 + 2)      # past exact-integer printing
    return reg, pre


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_and_snapshot_equal_the_reference(seed, tmp_path):
    for got, want in zip(_drive_registry(tobs, seed), _drive_registry(jobs, seed)):
        text = got.to_prometheus()
        assert text == want.to_prometheus()
        assert json.dumps(got.snapshot(), sort_keys=True, default=float) == \
            json.dumps(want.snapshot(), sort_keys=True, default=float)
        assert tobs.parse_prometheus(text) == jobs.parse_prometheus(text)
        got.write_prometheus(str(tmp_path / "a.prom"))
        got.write_json(str(tmp_path / "a.json"))
        want.write_json(str(tmp_path / "b.json"))
        assert (tmp_path / "a.prom").read_text() == text
        assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    capped = _drive_registry(tobs, seed)[0].get("capped")
    assert capped.count == 39 and len(capped.samples) <= 8


@pytest.mark.parametrize("n", [1, 2, 137])
def test_percentile_summary_equals_the_reference(n):
    xs = list(np.random.default_rng(n).exponential(0.02, size=n))
    got, want = tobs.percentile_summary(xs), jobs.percentile_summary(xs)
    assert got == want
    assert got["p50_ms"] == np.percentile(np.asarray(xs) * 1e3, 50)
    assert tobs.percentile_summary(xs, (90,), unit=1.0, suffix="_s") == \
        jobs.percentile_summary(xs, (90,), unit=1.0, suffix="_s")


@pytest.mark.parametrize("call", [
    lambda m: m.MetricsRegistry().counter("c").inc(-1),
    lambda m: (lambda r: (r.counter("x"), r.gauge("x")))(m.MetricsRegistry()),
    lambda m: m.MetricsRegistry().gauge("bad name"),
    lambda m: m.Histogram("h", buckets=()),
    lambda m: m.parse_prometheus("not a metric line at all!\n"),
    lambda m: m.parse_prometheus("untyped_metric 3\n"),
], ids=["negative_inc", "kind_clash", "bad_name", "no_buckets", "unparseable",
        "untyped"])
def test_metrics_refusals_equal_the_reference(call):
    with pytest.raises(ValueError) as got:
        call(tobs)
    with pytest.raises(ValueError) as want:
        call(jobs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _drive_tracer(tr):
    tr.event("admission", req=0, slot=1, plen=24, cached=16, chunks=1)
    for phase in ("decode", "chunk_prefill", "verify", "prefill", "other"):
        with tr.span("step", phase=phase):
            pass
    with tr.span("train_step", phase="train_step", step=3):
        pass
    with tr.span("serve", engine="static", requests=4):
        pass
    with tr.span("step", phase="decode", kernel="mine"):
        pass
    tr.complete("step", tr.t0 + 0.001, tr.t0 + 0.003, phase="verify")
    tr.event("retire")
    return tr.events


def _schema(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "dur")}


def test_tracer_events_have_the_reference_schema(tmp_path):
    assert set(ttrace.PHASE_KERNELS) == set(jtrace.PHASE_KERNELS)
    got, want = _drive_tracer(tobs.Tracer()), _drive_tracer(jobs.Tracer())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["ph"] == w["ph"] and g["name"] == w["name"]
        ga, wa = dict(g.get("args", {})), dict(w.get("args", {}))
        # the kernel names are each package's own: the port names its CUDA
        # kernels where the reference names its Pallas ones
        phase = ga.get("phase", g["name"])
        if phase in ttrace.PHASE_KERNELS and ga.get("kernel") != "mine":
            assert ga.pop("kernel") == ttrace.PHASE_KERNELS[phase]
            assert wa.pop("kernel") == jtrace.PHASE_KERNELS[phase]
        assert ga == wa
        if g["ph"] == "X":
            assert g["dur"] >= 0 and isinstance(g["ts"], float)
    np.testing.assert_allclose([got[-2]["ts"], got[-2]["dur"]], [1e3, 2e3], rtol=1e-6)
    path = str(tmp_path / "trace.jsonl")
    tr = tobs.Tracer(path=path)
    _drive_tracer(tr)
    tr.close()
    assert tobs.load_jsonl(path) == tr.events
    assert tr.dump(str(tmp_path / "dump.jsonl")) == len(tr.events)
    assert jobs.load_jsonl(str(tmp_path / "dump.jsonl")) == tr.events


def test_tracer_bounded_like_the_reference():
    got, want = tobs.Tracer(max_events=3), jobs.Tracer(max_events=3)
    for i in range(5):
        got.event("e", i=i)
        want.event("e", i=i)
    assert [_schema(e) for e in got.events] == [_schema(e) for e in want.events]
    assert got.dropped == want.dropped == 2


def _global_kernels():
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(r"__global__\s+(?:__launch_bounds__\([^)]*\)\s+)?void\s+"
                                r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src.read_text()))
    return names


@pytest.mark.parametrize("phase", sorted(ttrace.PHASE_KERNELS))
def test_phase_kernels_name_the_ports_cuda_kernels(phase):
    """Each name is a __global__ function of the port's CUDA sources, and
    the f32 train step names no flash kernel: it launches none (the
    reference's train_step entry names its flash kernels, which its
    default f32 step never runs)."""
    names = ttrace.PHASE_KERNELS[phase].split("+")
    assert names and set(names) <= _global_kernels(), names
    if phase == "train_step":
        assert not [n for n in names if n.startswith("flash")]
        assert "flash_attention_fwd" in jtrace.PHASE_KERNELS["train_step"]


def test_profile_is_a_no_op_without_a_dir_and_writes_a_chrome_trace(tmp_path):
    tr = tobs.Tracer()
    with tr.profile():
        torch.ones(4).sum()
    assert tr.events == []
    tr = tobs.Tracer(profile_dir=str(tmp_path / "prof"))
    with tr.profile("region"):
        with tr.profile("nested"):               # one profiler at a time
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert [e["name"] for e in tr.events] == ["profile_start", "profile_stop"]
    path = tr.events[-1]["args"]["path"]
    assert path == str(tmp_path / "prof" / "region.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events and not [e for e in events if e.get("cat") == "kernel"]   # no card
    assert not (tmp_path / "prof" / "nested.trace.json").exists()


# ---------------------------------------------------------------------------
# telemetry's host pieces
# ---------------------------------------------------------------------------

def test_flatten_stats_and_ring_equal_the_reference():
    rng = np.random.default_rng(3)
    recs = [{"logits": np.float32(rng.exponential()),
             "block/0_attn": rng.exponential(size=3).astype(np.float32),
             "u2w/embed": rng.exponential()} for _ in range(7)]
    assert tobs.flatten_stats(recs[0]) == jobs.flatten_stats(recs[0])
    assert tobs.flatten_stats({"t": torch.tensor([1.0, 2.0])}) == {"t/0": 1.0, "t/1": 2.0}
    got, want = tobs.RingBuffer(capacity=5), jobs.RingBuffer(capacity=5)
    for r in recs:
        got.append(r)
        want.append(r)
    assert (len(got), got.total) == (len(want), want.total) == (5, 7)
    assert got.records == want.records and got.last(2) == want.last(2)
    np.testing.assert_array_equal(got.series("block/0_attn/1"), want.series("block/0_attn/1"))
    assert got.mean_record() == want.mean_record()
    assert got.mean_record(last_n=2) == want.mean_record(last_n=2)
    for mod in (tobs, jobs):
        with pytest.raises(ValueError):
            mod.RingBuffer(capacity=0)
        with pytest.raises(ValueError):
            mod.RingBuffer().mean_record()


@pytest.mark.parametrize("seed", range(4))
def test_drift_detector_and_report_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(8)]
    base = {k: float(rng.exponential()) for k in keys}
    base["zero"] = 0.0
    kw = dict(tol=0.2, expected=float(rng.choice([0.0, 0.5])))
    got = tobs.DriftDetector(64, base, **kw)
    want = jobs.DriftDetector(64, base, **kw)
    for width in (64, 128, 256):
        # distinct factors: the report orders by |slope|, and the two
        # packages' slopes differ in float32 ulps, so a tie could reorder
        cur = {k: v * float(np.exp(rng.normal(0.0, 0.6))) for k, v in base.items()}
        g, w = got.observe(width, cur), want.observe(width, cur)
        assert (g.width, g.base_width, g.ok) == (w.width, w.base_width, w.ok)
        assert set(g.slopes) == set(w.slopes) and set(g.flagged) == set(w.flagged)
        for k in g.slopes:
            # the reference's log2 runs in jnp float32 (x64 off)
            assert g.slopes[k] == pytest.approx(w.slopes[k], rel=1e-5, abs=1e-6)
        assert str(g) == str(w)
    scoped = tobs.DriftDetector(64, base, keys=["k0", "missing"])
    assert set(scoped.observe(256, {"k0": 2.0}).slopes) == {"k0"}
    with pytest.raises(ValueError):
        tobs.DriftDetector(0, base)


def test_train_obs_records_and_flags_like_the_reference():
    snaps = []
    for mod in (tobs, jobs):
        obs = mod.TrainObs(metrics=mod.MetricsRegistry(), telemetry=True, verbose=False,
                           detector=mod.DriftDetector(64, {"logits": 1.0}, tol=0.2))
        rep = obs.record_step(0, loss=2.0, grad_norm=1.0, dt=0.1, tokens=512, width=256,
                              aux={"logits": 2.0})
        obs.record_step(1, loss=1.5, grad_norm=0.5, dt=0.2, tokens=512)
        assert not rep.ok and len(obs.ring) == 1 and len(obs.drift_reports) == 1
        snaps.append(obs.metrics.to_prometheus())
    assert snaps[0] == snaps[1]
    assert tobs.TrainObs().ring is None


def test_update_ratios_and_to_host():
    params = {"groups.0_attn.attn.wq": torch.zeros(2, 3), "embed": torch.full((4,), 2.0),
              "groups.0_attn.ln1": torch.ones(3)}
    updates = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    r = tobs.update_ratios(updates, params)
    assert list(r) == ["embed", "groups/0_attn/attn/wq", "groups/0_attn/ln1"]
    assert [float(v) for v in r.values()] == [0.25, 0.0, 0.5]
    host = ttelemetry.to_host({"a": torch.tensor(1.5), "b": torch.arange(3.0)})
    assert host["a"].shape == () and float(host["a"]) == 1.5
    np.testing.assert_array_equal(host["b"], [0.0, 1.0, 2.0])


# ---------------------------------------------------------------------------
# the model's statistics and the telemetry step, on the reference's weights
# ---------------------------------------------------------------------------

def _pair(p13n="mup", width=1.0, **over):
    jcfg = jsmoke("mup-gpt").replace(dtype="float32", n_layers=2, **over)
    # mup-gpt ties its embeddings, so zero_init_readout (no field of the
    # port's config) changes nothing there
    over.pop("zero_init_readout", None)
    tcfg = tsmoke("mup-gpt").replace(dtype="float32", n_layers=2, **over)
    jm = jbuild(jcfg.scaled(width).replace(parametrization=p13n))
    tm = tbuild(tcfg.scaled(width).replace(parametrization=p13n), device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(V, seq=32, batch=8, t=0):
    b = jpipeline(V, seq, batch, seed=0).batch(t)
    return {k: jnp.asarray(v) for k, v in b.items()}, \
        {k: torch.from_numpy(v) for k, v in tpipeline(V, seq, batch, seed=0).batch(t).items()}


@pytest.mark.parametrize("p13n", P13NS)
def test_loss_fn_collect_stats_matches_the_reference(p13n):
    jm, jp, tm, tp = _pair(p13n, zero_init_query=False)
    jb, tb = _batch(jm.cfg.vocab_size)
    jloss, jst = jm.loss_fn(jp, jb, collect_stats=True)
    tloss, tst = tm.loss_fn(tp, tb, collect_stats=True)
    assert set(tst) == set(jst) == {"embed", "block/0_attn", "final_norm", "logits"}
    for k in jst:
        assert tst[k].shape == tuple(jst[k].shape), k
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), err_msg=k, **ACT_TOL)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    # the plain loss and the logits are unchanged by collecting
    assert torch.equal(tm.loss_fn(tp, tb), tloss)
    logits, _, st = tm.forward(tp, tb["tokens"], collect_stats=True)
    assert torch.equal(logits, tm.forward(tp, tb["tokens"])[0]) and st.keys() == tst.keys()
    with pytest.raises(ValueError, match="exclusive"):
        tm.loss_fn(tp, tb, collect_acts=True, collect_stats=True)


@pytest.mark.parametrize("width", [1.0, 4.0])
@pytest.mark.parametrize("p13n", P13NS)
def test_step0_stats_match_the_coord_check_golden(p13n, width):
    """The online statistic is the offline coord check's: at step 0, on
    the golden harness's init and batch, embed and logits equal the
    committed fixture."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    over = dict(zero_init_readout=False, zero_init_query=False)
    jm, jp, tm, tp = _pair(p13n, width, **over)
    _, tb = _batch(256)
    _, stats = tm.loss_fn(tp, tb, collect_stats=True)
    want = golden[p13n][str(tm.cfg.d_model)][0]
    for key in ("embed", "logits"):
        np.testing.assert_allclose(float(stats[key]), want[key], rtol=5e-3,
                                   err_msg=f"{p13n} d_model={tm.cfg.d_model} {key}")


def _opts(jm, tm):
    return (JOptimizer.create("adam", lr=1e-2, parametrization=jm.p13n, meta=jm.meta),
            TOptimizer.create("adam", 1e-2, tm.p13n, tm.meta))


@pytest.mark.parametrize("zero_q", [True, False], ids=["zero_init_query", "random_query"])
def test_telemetry_step_matches_plain_and_reference(zero_q):
    jm, jp, tm, tp = _pair("mup", zero_init_query=zero_q)
    jopt, topt = _opts(jm, tm)
    jb, tb = _batch(jm.cfg.vocab_size)
    plain = tmake_step(tm, topt)
    instr = tmake_step(tm, topt, telemetry=True)
    p0, s0, m0 = plain(dict(tp), topt.init(tp), tb)
    p1, s1, m1 = instr(dict(tp), topt.init(tp), tb)
    # the statistics read detached tensors: the step is the plain one, bit for bit
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert set(m0) == {"loss", "grad_norm"}
    _, _, jm1 = jax.jit(jmake_step(jm, jopt, telemetry=True))(jp, jopt.init(jp), jb)
    jaux = jax.device_get(jm1["obs"])
    taux = ttelemetry.to_host(m1["obs"])
    assert list(taux) == list(jaux)                 # the reference's keys, in its order
    assert any(k.startswith("u2w/groups/") for k in taux)
    for k, want in jaux.items():
        tol = U2W_TOL if k.startswith("u2w/") else ACT_TOL
        np.testing.assert_allclose(taux[k], np.asarray(want), err_msg=k, **tol)
    assert tobs.flatten_stats(taux).keys() == jobs.flatten_stats(jaux).keys()


def test_telemetry_refuses_microbatching_like_the_reference():
    jm, _, tm, _ = _pair()
    jopt, topt = _opts(jm, tm)
    with pytest.raises(ValueError, match="telemetry") as got:
        tmake_step(tm, topt, telemetry=True, num_microbatches=2)
    with pytest.raises(ValueError) as want:
        jmake_step(jm, jopt, telemetry=True, num_microbatches=2)
    assert str(got.value) == str(want.value)


@functools.lru_cache(maxsize=None)
def _telemetry_run(p13n, width_mult, steps=3):
    """The reference test's run on the port: the smoke mup-gpt at 2 layers,
    Adam lr 1e-2, 8 x 32 tokens, telemetry every step."""
    cfg = tsmoke("mup-gpt").replace(dtype="float32", n_layers=2)
    cfg = cfg.scaled(width_mult).replace(parametrization=p13n)
    model = tbuild(cfg, device="cpu")
    params = model.init(0)
    opt = TOptimizer.create("adam", 1e-2, model.p13n, model.meta)
    state = opt.init(params)
    step = tmake_step(model, opt, telemetry=True)
    pipe = tpipeline(cfg.vocab_size, 32, 8, seed=0)
    ring = tobs.RingBuffer()
    for t in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(t).items()}
        params, state, metrics = step(params, state, batch)
        ring.append(ttelemetry.to_host(metrics["obs"]))
    return cfg.d_model, ring


@pytest.mark.parametrize("p13n,expect_flag", [("sp", True), ("mup", False), ("umup", False)])
def test_drift_detector_separates_sp_from_mup(p13n, expect_flag):
    """The reference's separation at 4x the proxy width, on the port's own
    init: SP's residual stream grows with width and is flagged (max
    |slope| > 0.5); µP and u-µP stay Theta(1)."""
    base_w, base_ring = _telemetry_run(p13n, 1.0)
    keys = [k for k in base_ring.last()[0] if k.startswith(("block/", "embed", "final_norm"))]
    assert keys
    det = tobs.DriftDetector.from_ring(base_w, base_ring, last_n=1, keys=keys, tol=0.25)
    wide_w, wide_ring = _telemetry_run(p13n, 4.0)
    assert wide_w == 4 * base_w
    report = det.observe(wide_w, wide_ring.last()[0])
    if expect_flag:
        assert not report.ok and max(abs(s) for s in report.flagged.values()) > 0.5
        assert "DRIFT" in str(report)
    else:
        assert report.ok, f"false positive on {p13n}: {report.flagged}"


# ---------------------------------------------------------------------------
# train_loop, the CLI, Experiment.train, run_sweep
# ---------------------------------------------------------------------------

def test_train_loop_with_obs():
    cfg = tsmoke("mup-gpt").replace(dtype="float32", n_layers=2)
    obs = tobs.TrainObs(metrics=tobs.MetricsRegistry(), telemetry=True, tracer=tobs.Tracer(),
                        verbose=False, every=2)
    out = ttrain.train_loop(cfg, steps=3, hps=HParams(lr=1e-2), batch_size=2, seq_len=16,
                            log_every=0, device="cpu", obs=obs)
    plain = ttrain.train_loop(cfg, steps=3, hps=HParams(lr=1e-2), batch_size=2, seq_len=16,
                              log_every=0, device="cpu")
    assert out["losses"] == plain["losses"]
    snap = obs.metrics.snapshot()
    assert snap["train_steps_total"] == 3 and snap["train_tokens_total"] == 3 * 2 * 16
    assert snap["train_step_seconds"]["count"] == 3
    assert snap["train_loss"] == out["losses"][-1]
    assert len(obs.ring) == 2                        # drained at steps 0 and 2
    spans = [e for e in obs.tracer.events if e["name"] == "train_step"]
    assert [e["args"]["step"] for e in spans] == [0, 1, 2]
    assert all(e["args"]["kernel"] == ttrace.PHASE_KERNELS["train_step"] for e in spans)
    tobs.parse_prometheus(obs.metrics.to_prometheus())


def test_train_cli_telemetry_obs_dir_writes_the_references_files(tmp_path):
    argv = ["--smoke", "--steps", "3", "--batch-size", "2", "--seq-len", "16",
            "--telemetry", "--obs-dir"]
    ttrain.main(argv + [str(tmp_path / "port"), "--device", "cpu"])
    jtrain.main(argv + [str(tmp_path / "ref")])
    files = {"metrics.prom", "metrics.json", "telemetry.jsonl", "trace.jsonl"}
    got = tmp_path / "port"
    assert {p.name for p in got.iterdir()} == files
    prom = tobs.parse_prometheus((got / "metrics.prom").read_text())
    want = jobs.parse_prometheus((tmp_path / "ref" / "metrics.prom").read_text())
    assert set(prom) == set(want) and prom["train_steps_total"] == 3
    assert json.loads((got / "metrics.json").read_text()).keys() == \
        json.loads((tmp_path / "ref" / "metrics.json").read_text()).keys()
    recs = tobs.load_jsonl(str(got / "telemetry.jsonl"))
    ref_recs = jobs.load_jsonl(str(tmp_path / "ref" / "telemetry.jsonl"))
    assert len(recs) == 3 and [list(r) for r in recs] == [list(r) for r in ref_recs]
    spans = tobs.load_jsonl(str(got / "trace.jsonl"))
    assert [e["name"] for e in spans] == ["train_step"] * 3


def test_experiment_train_with_obs():
    obs = tobs.TrainObs(metrics=tobs.MetricsRegistry(), telemetry=True, verbose=False)
    out = Experiment.from_config("mup-gpt", device="cpu", dtype="float32").train(
        steps=2, batch_size=2, seq_len=16, log_every=0, obs=obs)
    assert math.isfinite(out["final_loss"]) and len(obs.ring) == 2
    assert obs.metrics.snapshot()["train_steps_total"] == 2


def _sweep_events(tracer):
    out = []
    for e in tracer.events:
        a = dict(e.get("args", {}))
        a.pop("best_loss", None)
        out.append((e["name"], e["ph"], a))
    return out


def test_run_sweep_tracer_events_equal_the_reference(monkeypatch):
    """On the reference's init: a candidate that diverges at once and one
    too slow for the loss factor are pruned at the same steps, and the
    best is the same."""
    space = mup_space()
    cands = [space.hparams(lr=2e-2), space.hparams(lr=1e25), space.hparams(lr=1e-8),
             space.hparams(lr=5e-3)]
    kw = dict(steps=8, batch_size=4, seq_len=32, prune_factor=1.05, prune_every=4,
              verbose=False)
    jcfg = jsmoke("mup-gpt").replace(dtype="float32")
    model = jbuild(jcfg)
    from repro.core import tuning as jtuning
    from repro.core.init import init_params as jinit

    stacked = jax.vmap(lambda r: jinit(r, model.meta, model.p13n, sigma=1.0))(
        jtuning.candidate_rngs(0, len(cands)))
    init = params_from_numpy(flatten_tree(jax.tree_util.tree_map(np.asarray, stacked),
                                          lambda x: isinstance(x, np.ndarray)), device="cpu")
    monkeypatch.setattr(tsweep, "train_proxy_batched", functools.partial(
        ttuning.train_proxy_batched, init_fn=lambda gens, hp: init))
    got_tr, want_tr = tobs.Tracer(), jobs.Tracer()
    got = tsweep.run_sweep(tsmoke("mup-gpt"), cands, tracer=got_tr, device="cpu", **kw)
    want = jsweep.run_sweep(jcfg, cands, tracer=want_tr, **kw)
    assert _sweep_events(got_tr) == _sweep_events(want_tr)
    names = [e["name"] for e in got_tr.events]
    assert names.count("sweep") == 1 and names[-1] == "sweep_done"
    pruned = {i for e in got_tr.events if e["name"] == "prune" for i in e["args"]["candidates"]}
    assert {1, 2} <= pruned
    done = got_tr.events[-1]["args"]
    assert done["best"] == got.best_index == want.best_index
    assert done["best_loss"] == pytest.approx(want.best_loss, rel=2e-3)
