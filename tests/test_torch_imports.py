"""The port stands alone: no module of kubeflow_tpu_torch, and neither
chip_smoke.py nor kernel_times.py, imports JAX, flax, optax, orbax or the
JAX package."""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]
# an import statement (or import_module call) naming a forbidden package;
# kubeflow_tpu matches only where _torch does not follow
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax"
    r"|kubeflow_tpu(?!_torch))\b"
    r"|import_module\(\s*['\"](?:jax|flax|optax|orbax|kubeflow_tpu(?!_torch))",
    re.MULTILINE)


def test_port_files_exist():
    assert len(FILES) > 10, FILES
    # the serving engine's modules and the own copies it needs are checked
    # below like every other module of the port
    for rel in ("serving/continuous.py", "serving/fleet/pagedkv.py",
                "serving/fleet/__init__.py", "tracing/core.py",
                "tracing/export.py", "tracing/__init__.py",
                "models/speculative.py", "serving/fleet/router.py",
                "serving/fleet/loadtest.py", "serving/fleet/wire.py"):
        assert ROOT / "kubeflow_tpu_torch" / rel in FILES, rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
