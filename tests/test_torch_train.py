"""The port's training path against the reference on the same weights,
batches and gradients.

Weights come from the reference's init (``zero_init_query=False``, so
attention is not uniform) and move into the port by dotted name through
``convert.params_from_numpy``; batches come from both data pipelines (equal
bit for bit); optimizer inputs are numpy arrays handed to both sides.
Tolerances (docs/kernels.md tiers): the loss at float32 atol 2e-5 (plus
rtol 1e-6, a few float32 ulps: at 1/8 width the random-init loss is ~164,
where one ulp is 1.5e-5), gradients and parameters at atol 2e-4 / rtol 1e-3, losses over three train
steps at 1e-4 relative.  Optimizer arithmetic, schedules and clipping are
elementwise, so they are held tighter (atol 1e-7 / rtol 1e-5).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import transfer as jtransfer  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import grad as jgrad  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.optimizer import Optimizer as JOptimizer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import transfer as ttransfer  # noqa: E402
from repro_torch.data.pipeline import make_pipeline as tpipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_step  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.optim import grad as tgrad  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim.optimizer import Optimizer as TOptimizer  # noqa: E402

LOSS_TOL = dict(atol=2e-5, rtol=1e-6)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
ELEM_TOL = dict(atol=1e-7, rtol=1e-5)

CONFIGS = {
    "mup-gpt-smoke": lambda m: m.get_smoke_config("mup-gpt").replace(
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """A reference pytree of arrays -> the port's {dotted name: tensor}."""
    return params_from_numpy(_np_tree(tree), device="cpu")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(reference model, its params, port model, the same params)."""
    make = CONFIGS[request.param]
    jm = jbuild(make(jconfigs))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(make(tconfigs), device="cpu")
    return jm, jp, tm, _flat(jp)


def _batch(cfg, B=2, S=12, seed=0):
    """Tokens and labels with masked (-100) positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, -1] = -100
    return {"tokens": toks, "labels": labels}


def _to(batch, side):
    if side == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _assert_trees_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(
            got[name].detach().float().numpy(), want[name].float().numpy(),
            err_msg=name, **tol)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference(pair):
    jm, jp, tm, tp = pair
    batch = _batch(jm.cfg)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jp, _to(batch, "jax"))
    tloss, tgrads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_trees_close(tgrads, _flat(jgrads), **GRAD_TOL)


def test_loss_collect_acts_and_all_masked(pair):
    jm, jp, tm, tp = pair
    batch = _batch(jm.cfg)
    loss, acts = tm.loss_fn(tp, _to(batch, "torch"), collect_acts=True)
    jloss, jacts = jm.loss_fn(jp, _to(batch, "jax"), collect_acts=True)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(acts["logits"].detach().numpy(),
                               np.asarray(jacts["logits"]), atol=1e-4, rtol=1e-4)
    batch["labels"][:] = -100
    loss, grads = tgrad.value_and_grad(tm.loss_fn, tp, _to(batch, "torch"))
    assert float(loss) == 0.0
    assert all(torch.count_nonzero(g) == 0 for g in grads.values())


# ---------------------------------------------------------------------------
# optimizer, schedules, gradient utilities
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw+wd+lr_embed": dict(kind="adamw", lr=2e-2, weight_decay=0.1,
                              lr_embed=3e-3, mup_scale_eps=True, eps=1e-4),
    "sgd+momentum": dict(kind="sgd", lr=0.5, momentum=0.9, weight_decay=0.01),
    "adagrad": dict(kind="adagrad", lr=1e-2, eps=1e-3),
    "adam": dict(kind="adam", lr=1e-2, lr_embed=5e-2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_reference(pair, name):
    """Two updates (so the moments and bias corrections carry over), with a
    warmup/decay schedule and random params and grads."""
    jm, jp, tm, _ = pair
    kw = dict(OPTIMIZERS[name])
    kind, lr = kw.pop("kind"), kw.pop("lr")
    jopt = JOptimizer.create(
        kind, lr, jm.p13n, jm.meta,
        schedule=jsched.linear_decay(10, warmup_steps=3), **kw)
    topt = TOptimizer.create(
        kind, lr, tm.p13n, tm.meta,
        schedule=tsched.linear_decay(10, warmup_steps=3), **kw)
    rng = np.random.default_rng(1)
    rand = lambda _: rng.standard_normal(np.shape(_)).astype(np.float32)  # noqa: E731
    jparams = jax.tree_util.tree_map(rand, jp)
    tparams = _flat(jparams)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(2):
        jg = jax.tree_util.tree_map(rand, jp)
        jupd, jstate = jopt.update(jg, jstate, jparams)
        tupd, tstate = topt.update(_flat(jg), tstate, tparams)
        _assert_trees_close(tupd, _flat(jupd), **ELEM_TOL)
    assert tstate["count"] == int(jstate["count"]) == 2
    for moment in ("mu", "nu"):
        if moment in jstate:
            _assert_trees_close(tstate[moment], _flat(jstate[moment]), **ELEM_TOL)
    # the static per-tensor tables: µP LR multipliers and the lr_embed mask
    for table in ("lr_mults", "eps_mults", "embed_lr_mask"):
        want = params_from_numpy(jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), getattr(jopt, table)), device="cpu")
        got = getattr(topt, table)
        assert {n: float(v) for n, v in want.items()} == got, table
    assert topt.embed_lr_mask["embed"] == 1.0


def test_plain_adam_with_weight_decay_is_refused(pair):
    _, _, tm, _ = pair
    with pytest.raises(ValueError, match="adamw"):
        TOptimizer.create("adam", 1e-2, tm.p13n, tm.meta, weight_decay=0.1)


SCHEDULES = [
    ("constant", {}),
    ("linear", dict(total_steps=50, warmup_steps=7, end_factor=0.1)),
    ("cosine", dict(total_steps=40, warmup_steps=5, end_factor=0.05)),
    ("step", dict(milestones=[3, 9], gamma=0.3)),
    ("inv_sqrt", dict(warmup_steps=6)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_reference(name, kw):
    j = jsched.make_schedule(name, **kw)
    t = tsched.make_schedule(name, **kw)
    want = np.array([float(j(jnp.int32(s))) for s in range(60)], np.float32)
    got = np.array([t(s) for s in range(60)], np.float32)
    np.testing.assert_allclose(got, want, **ELEM_TOL)


@pytest.mark.parametrize("max_norm", [0.1, 1e6])
def test_clip_and_compress_match_reference(max_norm):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    flat = params_from_numpy(tree, device="cpu")
    jclipped, jnorm = jgrad.clip_by_global_norm(tree, max_norm)
    tclipped, tnorm = tgrad.clip_by_global_norm(flat, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), **ELEM_TOL)
    _assert_trees_close(tclipped, _flat(jclipped), **ELEM_TOL)
    residual = jax.tree_util.tree_map(lambda a: 1e-3 * a, tree)
    jq, jres = jgrad.compress_bf16(tree, residual)
    tq, tres = tgrad.compress_bf16(flat, params_from_numpy(_np_tree(residual),
                                                           device="cpu"))
    _assert_trees_close(tq, _flat(jq), atol=0, rtol=0)
    _assert_trees_close(tres, _flat(jres), atol=0, rtol=0)


def test_microbatch_accumulation_matches_reference(pair):
    jm, jp, tm, tp = pair
    batch = _batch(jm.cfg, B=4, seed=5)
    jloss, jgrads = jgrad.accumulate_gradients(jm.loss_fn, jp, _to(batch, "jax"), 2)
    tloss, tgrads = tgrad.accumulate_gradients(tm.loss_fn, tp, _to(batch, "torch"), 2)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_trees_close(tgrads, _flat(jgrads), **GRAD_TOL)


# ---------------------------------------------------------------------------
# data, transfer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 16, 4, 0), (2048, 33, 3, 7)])
def test_synthetic_batches_equal_bit_for_bit(vocab, seq, batch, seed):
    jp_, tp_ = jpipeline(vocab, seq, batch, seed=seed), tpipeline(vocab, seq, batch, seed=seed)
    for step in (0, 1, 17):
        jb, tb = jp_.batch(step), tp_.batch(step)
        for k in ("tokens", "labels"):
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tp_.markov_entropy_bound() == jp_.markov_entropy_bound()


HPARAMS = [
    {},
    dict(lr=3e-3, sigma=0.5, alpha_output=4.0, alpha_attn=2.0, lr_embed=1e-3),
    dict(alpha_embed=10.0, b1=0.8, momentum=0.9, warmup_steps=5,
         schedule="cosine"),
]


@pytest.mark.parametrize("parametrization", ["mup", "sp", "umup"])
@pytest.mark.parametrize("hp", range(len(HPARAMS)))
def test_transfer_plans_match_reference(parametrization, hp):
    kw = HPARAMS[hp]
    jcfg = jconfigs.get_config("mup-gpt").replace(parametrization=parametrization)
    tcfg = tconfigs.get_config("mup-gpt").replace(parametrization=parametrization)
    jh, th = jtransfer.HParams(**kw), ttransfer.HParams(**kw)
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    if parametrization == "umup" and kw.get("sigma", 1.0) != 1.0:
        for fn, h, cfg in ((jtransfer.transfer, jh, jcfg),
                           (ttransfer.transfer, th, tcfg)):
            with pytest.raises(ValueError, match="sigma"):
                fn(h, cfg)
        return
    assert ttransfer.transfer(th, tcfg) == jtransfer.transfer(jh, jcfg)


def test_transfer_taxonomy_and_proxy_match_reference():
    assert ttransfer.MU_TRANSFERABLE == jtransfer.MU_TRANSFERABLE
    assert ttransfer.NOT_TRANSFERABLE == jtransfer.NOT_TRANSFERABLE
    with pytest.warns(UserWarning, match="weight_decay"):
        ttransfer.transfer(ttransfer.HParams(weight_decay=0.1),
                           tconfigs.get_config("mup-gpt"))
    for width, depth in ((0.25, None), (0.5, 4), (0.125, 2)):
        jp_ = jtransfer.make_proxy(jconfigs.get_config("mup-gpt"), width, depth)
        tp_ = ttransfer.make_proxy(tconfigs.get_config("mup-gpt"), width, depth)
        for f in dataclasses.fields(tp_):
            assert getattr(tp_, f.name) == getattr(jp_, f.name), f.name


# ---------------------------------------------------------------------------
# train steps, checkpoint resume, CLI
# ---------------------------------------------------------------------------

def test_three_train_steps_match_reference(pair):
    """make_train_step (AdamW, linear schedule, clipping) for three steps
    from the same weights on the same batches.

    Adam's eps is 1e-5, not 1e-8: after clipping, the two frameworks'
    gradients differ by float32 rounding (~1e-8 per element), and with eps
    1e-8 an element whose gradient is that small flips sign and moves by a
    full 2 * lr * lr_mult (about one element in 30,000 here) — a property of
    Adam, not of either side.  With eps 1e-5 such an element moves by ~1e-5
    while every other update stays Adam-normalized (|g| ~ 1e-3)."""
    jm, jp, tm, tp = pair
    cfg = jm.cfg
    kw = dict(weight_decay=0.01, eps=1e-5)
    jopt = JOptimizer.create("adamw", 1e-2, jm.p13n, jm.meta,
                             schedule=jsched.linear_decay(3, warmup_steps=1), **kw)
    topt = TOptimizer.create("adamw", 1e-2, tm.p13n, tm.meta,
                             schedule=tsched.linear_decay(3, warmup_steps=1), **kw)
    jstep = jax.jit(jmake_step(jm, jopt))
    tstep = tmake_step(tm, topt)
    pipe = tpipeline(cfg.vocab_size, 16, 2, seed=3)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for t in range(3):
        b = pipe.batch(t)
        jp, jstate, jm_ = jstep(jp, jstate, _to(b, "jax"))
        tp, tstate, tm_ = tstep(tp, tstate, _to(b, "torch"))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]),
                                   rtol=1e-4)
    _assert_trees_close(tp, _flat(jp), **GRAD_TOL)


def _small_run(tmp_path=None, **kw):
    cfg = tconfigs.get_smoke_config("mup-gpt").replace(dtype="float32")
    return ttrain.train_loop(
        cfg, steps=6, hps=ttrain.HParams(lr=1e-2), batch_size=2, seq_len=16,
        ckpt_every=2, log_every=0, device="cpu",
        ckpt_dir=None if tmp_path is None else str(tmp_path), **kw)


def test_checkpoint_resume_ends_where_uninterrupted_run_ends(tmp_path):
    full = _small_run()
    with pytest.raises(ttrain.SimulatedFailure):
        _small_run(tmp_path, simulate_failure_at=3)
    resumed = _small_run(tmp_path)
    assert resumed["steps_run"] == 4          # from the step-2 checkpoint
    assert resumed["losses"] == full["losses"][2:]
    for name, p in full["params"].items():
        assert torch.equal(resumed["params"][name], p), name
    assert math.isfinite(full["final_loss"]) and full["losses"][-1] < full["losses"][0]


def test_checkpointer_keeps_three_and_restores_like_the_template(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    assert ckpt.latest_step() is None
    state = ({"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "h": torch.ones(4, dtype=torch.bfloat16)},
             {"count": 0, "mu": {"w": torch.zeros(2, 3)}})
    for step in range(1, 6):
        state[1]["count"] = step
        state[0]["w"] = state[0]["w"] + 1
        ckpt.save(step, state, extra={"at": step}, async_save=step % 2 == 0)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4, 5] and ckpt.latest_step() == 5
    template = ({"w": torch.zeros(2, 3), "h": torch.zeros(4, dtype=torch.bfloat16)},
                {"count": 0, "mu": {"w": torch.ones(2, 3)}})
    (params, opt), step, extra = ckpt.restore(template)
    assert step == 5 and extra == {"at": 5} and opt["count"] == 5
    assert torch.equal(params["w"], state[0]["w"]) and params["h"].dtype == torch.bfloat16
    assert torch.equal(opt["mu"]["w"], torch.zeros(2, 3))
    (params, _), step, _ = ckpt.restore(template, step=3)
    assert step == 3 and torch.equal(params["w"], torch.arange(6.0).reshape(2, 3) + 3)
    assert not [n for n in tmp_path.iterdir() if n.name.startswith(".tmp")]


def test_compressed_microbatched_run_stays_finite():
    out = _small_run(num_microbatches=2, compress_grads=True)
    assert all(math.isfinite(v) for v in out["losses"])


def test_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run for real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("flags", [["--amp", "int8"], ["--model-parallel", "2"],
                                   ["--fsdp"], ["--telemetry"], ["--obs-dir", "x"]])
def test_cli_refuses_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--smoke", "--device", "cpu", *flags])
    assert exc.value.code != 0
    assert "not ported yet" in capsys.readouterr().err


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    out = ttrain.main(["--smoke", "--device", "cpu", "--steps", "3",
                       "--batch-size", "2", "--seq-len", "8",
                       "--ckpt-dir", str(tmp_path), "--simulate-failure", "1",
                       "--ckpt-every", "1", "--parametrization", "umup"])
    assert out["steps_run"] == 2 and math.isfinite(out["final_loss"])


def test_cli_trains_under_amp_bf16_on_the_cpu():
    """--amp bf16 sets cfg.amp: attention and the readout run their bf16
    plain versions on the CPU, and the losses differ from the f32 run's."""
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch-size", "2",
            "--seq-len", "16"]
    amp = ttrain.main(argv + ["--amp", "bf16"])
    f32 = ttrain.main(argv)
    assert amp["steps_run"] == 3 and all(math.isfinite(x) for x in amp["losses"])
    assert amp["losses"] != f32["losses"]
