"""The port's ``Experiment`` façade (``repro_torch.api``) and sweep CLI
(``repro_torch.launch.sweep``) on the CPU, at smoke size.

- Algorithm 1 end to end: ``proxy`` -> ``coord_check`` -> ``tune`` ->
  ``transfer`` -> ``train``; ``tune`` stores the best candidate, ``train``
  runs on the transferred HPs.
- ``transfer_plan`` equals the reference's under µP and u-µP; a u-µP proxy
  sweeps no sigma; unported options (``mesh=``, ``obs=``) are refused.
- ``serving_engine`` picks the engine class the reference's rule picks
  (the reference's ``Experiment.serving_engine`` on the same overrides),
  and its greedy tokens equal those of the engine built by hand.
- The sweep CLI with ``--device cpu`` streams and prints its ranking;
  a bad ``--lrs``, ``--devices 2`` and a ``tracer`` are refused.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.api import Experiment as JExperiment  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.core.coord_check import BatchedCoordCheckResult, CoordCheckResult  # noqa: E402
from repro_torch.core.hpspace import mup_space  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

SWEEP = dict(steps=3, batch_size=2, seq_len=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_algorithm1_end_to_end_on_the_cpu():
    exp = Experiment.from_config("mup-gpt", device="cpu")
    proxy = exp.proxy(0.5)
    assert proxy.cfg.d_model == exp.cfg.d_model // 2 and proxy.device == "cpu"
    assert proxy.cfg.base_d_model == exp.cfg.base_d_model
    one = proxy.coord_check(widths=(1.0, 2.0), steps=2, batch_size=2, seq_len=16)
    many = proxy.coord_check(widths=(1.0, 2.0), steps=2, batch_size=2, seq_len=16,
                             lrs=(1e-3, 1e-2))
    assert isinstance(one, CoordCheckResult) and isinstance(many, BatchedCoordCheckResult)
    assert sorted(one.records) == sorted(many.records) == [32, 64]
    view = many.candidate_view(1).records
    for w in one.records:
        for a, b in zip(one.records[w], view[w]):
            assert a.keys() == b.keys()
            for k in a:
                assert b[k] == pytest.approx(a[k], rel=5e-3, abs=1e-6), (w, k)
    assert math.isfinite(one.growth("logits.delta"))

    res = proxy.tune(n_samples=4, **SWEEP)
    assert res.steps_run == 3 and len(res.candidates) == 4
    assert proxy.hps == res.best == mup_space().sample_n(4, 0)[res.best_index]
    target = proxy.transfer(exp)
    assert target.hps == res.best and target.cfg == exp.cfg and target.device == "cpu"
    out = target.train(steps=3, batch_size=2, seq_len=16, log_every=0)
    assert len(out["losses"]) == 3 and all(math.isfinite(x) for x in out["losses"])
    with pytest.raises(ValueError, match="tune"):
        Experiment.from_config("mup-gpt", device="cpu").transfer(exp)


@pytest.mark.parametrize("parametrization", ["mup", "umup"])
def test_transfer_plan_and_space_match_reference(parametrization):
    exp = Experiment.from_config("mup-gpt", parametrization=parametrization, device="cpu")
    jexp = JExperiment.from_config("mup-gpt", parametrization=parametrization)
    space = exp.space
    assert space.names() == jexp.space.names()
    hps = space.hparams(lr=3e-3, alpha_output=2.0, alpha_attn=0.5, b1=0.8)
    assert exp.transfer_plan(hps) == jexp.transfer_plan(hps)
    assert exp.transfer_plan() == jexp.transfer_plan()
    assert exp.cfg.hp_space().name == jexp.cfg.hp_space().name
    if parametrization == "umup":
        # u-µP sweeps no sigma: every drawn candidate keeps it at 1
        res = exp.proxy(0.5).tune(n_samples=3, **SWEEP)
        assert {h.sigma for h in res.candidates} == {1.0}
    opt = exp.optimizer(hps=hps)
    assert (opt.lr, opt.b1) == (3e-3, 0.8)


def test_unported_options_are_refused():
    exp = Experiment.from_config("mup-gpt", device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        exp.serving_engine(mesh=object())
    with pytest.raises(ValueError, match="unknown parametrization"):
        Experiment.from_config("mup-gpt", parametrization="nope")
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else Exception):
        Experiment.from_config("mup-gpt").build()   # the card unless asked for the CPU


ENGINE_OVERRIDES = [dict(), dict(prefix_cache=True), dict(prefill_chunk=8),
                    dict(n_pages=64), dict(draft_k=2)]


@pytest.mark.parametrize("overrides", ENGINE_OVERRIDES, ids=lambda o: ",".join(o) or "none")
def test_serving_engine_picks_the_reference_class(overrides):
    kw = dict(n_slots=2, page_size=8, max_prompt_len=16, max_gen_len=4, **overrides)
    arch = "smollm-135m"
    exp = Experiment.from_config(arch, device="cpu", dtype="float32")
    jexp = JExperiment.from_config(arch, dtype="float32")
    drafter = exp.proxy(0.5, min_d_head=8) if "draft_k" in overrides else None
    jdrafter = jexp.proxy(0.5, min_d_head=8) if drafter else None
    got = exp.serving_engine(drafter=drafter, **kw)
    want = jexp.serving_engine(drafter=jdrafter, **kw)
    assert type(got).__name__ == type(want).__name__
    assert (got.draft_model is not None) == (drafter is not None)


def test_serving_engine_tokens_equal_the_engine_built_by_hand():
    exp = Experiment.from_config("smollm-135m", device="cpu", dtype="float32")
    kw = dict(n_slots=2, page_size=8, max_prompt_len=16, max_gen_len=5)
    params = exp.build().init(0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, exp.cfg.vocab_size, (3, 16))
    lens = np.array([16, 9, 12])
    got = exp.serving_engine(**kw).serve(params, prompts, lens)
    want = Engine(build_model(exp.cfg, device="cpu"), EngineConfig(**kw)).serve(
        params, prompts, lens)
    assert torch.equal(torch.as_tensor(got["tokens"]), torch.as_tensor(want["tokens"]))
    engine = exp.serving_engine(engine_config=EngineConfig(**kw), prefix_cache=True)
    assert type(engine).__name__ == "DynamicEngine"
    assert dataclasses.replace(EngineConfig(**kw), prefix_cache=True) == engine.ecfg


def test_sweep_cli_ranks_on_the_cpu(capsys):
    res = sweep.main(["--device", "cpu", "--n", "3", "--steps", "2", "--batch-size", "2",
                      "--seq-len", "16", "--prune-factor", "100"])
    out = capsys.readouterr().out
    assert "[sweep] 3 candidates x 2 steps on 1 device (cpu)" in out
    assert "[sweep] step    0" in out and "[sweep] ranking (3 candidates):" in out
    assert "[sweep] best: lr=" in out and len(res.candidates) == 3
    assert res.candidates == mup_space().sample_n(3, 0)
    res = sweep.main(["--device", "cpu", "--lrs", "1e-3,1e25", "--steps", "3",
                      "--batch-size", "2", "--seq-len", "16"])
    assert [h.lr for h in res.candidates] == [1e-3, 1e25]
    assert "[pruned]" in capsys.readouterr().out


@pytest.mark.parametrize("flags, match", [
    (["--lrs", "1e-3,abc"], "comma-separated floats"),
    (["--lrs", ","], "--lrs is empty"),
    (["--devices", "2"], "multi-GPU slice"),
    (["--n", "0"], "--n must be >= 1"),
    (["--parametrization", "umup", "--lrs", "1e-3", "--sigma", "2"], "not an axis"),
])
def test_sweep_cli_refuses(flags, match, capsys):
    with pytest.raises(SystemExit) as exc:
        sweep.main(["--device", "cpu", *flags])
    assert exc.value.code != 0
    assert match in capsys.readouterr().err


def test_run_sweep_refuses_unported_options():
    cfg = Experiment.from_config("mup-gpt").cfg
    cands = mup_space().sample_n(2, 0)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        sweep.run_sweep(cfg, cands, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        sweep.run_sweep(cfg, [], device="cpu")
