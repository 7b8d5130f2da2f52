"""Guards of the PyTorch port: no JAX, and no silent CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pulpo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "pulpo_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


BLOCKED_IMPORT = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pulpo_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import importlib, pkgutil, numpy as np
import pulpo_tpu_torch
for m in pkgutil.walk_packages(pulpo_tpu_torch.__path__, "pulpo_tpu_torch."):
    importlib.import_module(m.name)
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.uq.predict import predict_with_uncertainty
cfg = PULPoConfig(input_size=(8, 10, 12), total_levels=2, latent_levels=2, n0=4)
m = PULPoModel(cfg, device="cpu"); m.init(0)
x = np.random.default_rng(0).random((1, 8, 10, 12, 1), dtype=np.float32)
r = predict_with_uncertainty(m, x, x, 2)
assert not any(k.split(".")[0] in ("jax", "flax", "pulpo_tpu") for k in sys.modules)
print("ok")
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_model_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PULPoConfig(input_size=(8, 8, 8), total_levels=2, latent_levels=2, n0=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PULPoModel(cfg)
    with pytest.raises(RuntimeError):
        PULPoModel(cfg, device="cuda")
    assert PULPoModel(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
