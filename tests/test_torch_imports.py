"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX, ``ml_dtypes`` or the JAX package, and the
port imports in a process where ``import jax`` fails."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "import repro_torch.models.lm, repro_torch.serving.engine\n"
        "import repro_torch.launch.serve, repro_torch.weights\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.kv_layout\n"
        "import repro_torch.serving.state_pool\n"
        "import repro_torch.serving.speculative, repro_torch.serving.sampling\n"
        "import repro_torch.serving.prng\n"
        "import repro_torch.launch.train, repro_torch.launch.quickstart\n"
        "import repro_torch.launch.checkpoint, repro_torch.data.synthetic\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.telemetry, repro_torch.telemetry.clock\n"
        "import repro_torch.telemetry.metrics, repro_torch.telemetry.spans\n"
        "import repro_torch.telemetry.schema, repro_torch.serving.faults\n"
        "import repro_torch.serving.admission, repro_torch.serving.service\n"
        "import repro_torch.configs.cnn, repro_torch.models.cnn\n"
        "import repro_torch.core.calibration, repro_torch.roofline\n"
        "import repro_torch.roofline.hardware, repro_torch.repro_exp\n"
        "import repro_torch.repro_exp.cnn_experiment\n"
        "import repro_torch.models.moe, repro_torch.configs\n"
        "from repro_torch.configs import (arctic_480b, command_r_35b,\n"
        "    granite_3_8b, phi35_moe_42b, stablelm_1_6b)\n"
        "import repro_torch.models.ssm, repro_torch.configs.jamba_1_5_large\n"
        "import repro_torch.models.xlstm, repro_torch.configs.xlstm_1_3b\n"
        "from repro_torch.configs import phi_3_vision_4_2b, musicgen_medium\n"
        "import repro_torch.sharding, repro_torch.sharding.ctx\n"
        "import repro_torch.sharding.rules, repro_torch.launch.mesh\n"
        "import repro_torch.launch.elastic, repro_torch.launch.dryrun\n"
        "import repro_torch.roofline.cost\n"
        "import repro_torch.analysis, repro_torch.analysis.astlint\n"
        "import repro_torch.analysis.dispatch_checks\n"
        "import repro_torch.scripts.check_static\n"
        "import repro_torch.scripts.http_smoke\n"
        "import repro_torch.scripts.chaos_smoke\n"
        "import repro_torch.scripts.trace_smoke\n"
        "assert 'triton' not in sys.modules\n")
    env_path = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
