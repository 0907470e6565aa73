"""The port stands alone: no module of kubeflow_tpu_torch, and neither
chip_smoke.py nor kernel_times.py, imports JAX, flax, optax, orbax or the
JAX package. The serving artifacts' modules import with jax, flax, msgpack
and grpc blocked, and chip_smoke.py alone, without the package, exits
with an error and prints no result."""

import re
import shutil
import subprocess
import sys
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
    # the serving engine's modules, the own copies it needs and the model
    # families are checked below like every other module of the port
    for rel in ("serving/continuous.py", "serving/fleet/pagedkv.py",
                "serving/fleet/__init__.py", "tracing/core.py",
                "tracing/export.py", "tracing/__init__.py",
                "models/speculative.py", "serving/fleet/router.py",
                "serving/fleet/loadtest.py", "serving/fleet/wire.py",
                "serving/fleet/podworker.py", "serving/fleet/podclient.py",
                "serving/fleet/scaler.py", "utils/envvars.py",
                "utils/retry.py", "health.py", "models/layers.py",
                "models/conv.py", "models/resnet.py", "models/mnist.py",
                "models/bert.py", "models/vit.py", "models/__init__.py",
                "utils/compile_cache.py", "serving/quant.py",
                "serving/aot.py", "serving/storage.py", "serving/agent.py",
                "serving/server.py", "kernels/dropout.py",
                "train/tokenizer.py", "train/bpe_gpt2.py", "train/lora.py",
                "train/convert.py", "cli.py", "__main__.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/partitioner.py", "parallel/sharding.py",
                "parallel/moe.py", "runtime/__init__.py",
                "runtime/distributed.py", "parallel/ring_attention.py",
                "train/losses.py"):
        assert ROOT / "kubeflow_tpu_torch" / rel in FILES, rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


# a fresh interpreter in which importing jax, flax, msgpack or grpc fails
_BLOCKED_IMPORT = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "grpc"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import kubeflow_tpu_torch.serving.quant
import kubeflow_tpu_torch.serving.aot
import kubeflow_tpu_torch.serving.storage
import kubeflow_tpu_torch.serving.agent as agent
import kubeflow_tpu_torch.serving.server as server
import kubeflow_tpu_torch.serving.model as model
import kubeflow_tpu_torch.kernels.flash_fwd
from kubeflow_tpu_torch.convert import flax_msgpack_restore
assert agent.MicroBatcher and server.ModelServer and model.ExplainedModel
# a flax params.msgpack made by hand: {"params": {"w": float32 [1.5]}}
inner = bytes([0x93, 0x91, 0x01, 0xa7]) + b"float32" + bytes([0xc4, 4]) \\
    + bytes.fromhex("0000c03f")
raw = bytes([0x81, 0xa6]) + b"params" + bytes([0x81, 0xa1]) + b"w" \\
    + bytes([0xc7, len(inner), 1]) + inner
assert flax_msgpack_restore(raw)["params"]["w"].tolist() == [1.5]
assert not any(m.split(".")[0] in ("jax", "flax", "msgpack", "grpc")
               for m in sys.modules)
print("ok")
"""


def test_serving_modules_import_with_jax_msgpack_grpc_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """chip_smoke.py copied alone into an empty directory exits with an
    error and prints no result line (on a machine with a card it stops at
    the missing package; here at the missing card)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
