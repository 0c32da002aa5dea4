"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports JAX or the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_imports_without_jax_or_reference():
    """Import every port module in a fresh process where ``jax`` and
    ``repro`` are blocked in sys.modules (any import of them raises)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(' '.join(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 44
    training = {
        "repro_torch.core.hpspace", "repro_torch.core.transfer",
        "repro_torch.kernels.cross_entropy", "repro_torch.optim.optimizer",
        "repro_torch.optim.schedules", "repro_torch.optim.grad",
        "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpoint",
        "repro_torch.launch.steps", "repro_torch.launch.train",
        "repro_torch.core.coord_check",
    }
    assert training <= mods, training - mods
    amp = {"repro_torch.quant", "repro_torch.quant.policy", "repro_torch.quant.core",
           "repro_torch.quant.kv", "repro_torch.kernels.flash_attention"}
    assert amp <= mods, amp - mods
    serving = {"repro_torch.serving.allocator", "repro_torch.serving.engine",
               "repro_torch.serving.kv_cache", "repro_torch.kernels.decode_attention",
               "repro_torch.serving.sampling", "repro_torch.data.copy_task"}
    assert serving <= mods, serving - mods
    obs = {"repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
           "repro_torch.obs.telemetry"}
    assert obs <= mods, obs - mods
    moe = {"repro_torch.models.moe", "repro_torch.configs.mixtral_8x22b",
           "repro_torch.configs.llama4_scout_17b_a16e"}
    assert moe <= mods, moe - mods
    recurrent = {"repro_torch.models.ssm", "repro_torch.models.rglru",
                 "repro_torch.configs.mamba2_130m", "repro_torch.configs.recurrentgemma_9b"}
    assert recurrent <= mods, recurrent - mods


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")] + [Path("chip_smoke.py")]
), ids=str)
def test_no_forbidden_import_statement(path):
    """Static check, which also sees imports inside functions."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA it exits non-zero and prints no result line; alone in a
    directory (without the port beside it) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run for real")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
