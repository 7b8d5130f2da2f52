"""Guards of the PyTorch port: no JAX, and no silent CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
# the port, chip_smoke.py and the tests' worker scripts that run the port
# in processes of their own (tests/torch_*.py)
PORT_FILES = (sorted((ROOT / "pulpo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tests").glob("torch_*.py")))
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


HOST_ONLY = ("pandas", "tensorboardX", "matplotlib")  # not on the card's machine
# the functions that draw: a figure from its panels, a table as its SVG
DRAWERS = {ROOT / "pulpo_tpu_torch" / "eval" / "visualize.py": "draw",
           ROOT / "pulpo_tpu_torch" / "eval" / "tables.py": "_draw_svg"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_pandas_or_tensorboard_and_matplotlib_only_in_draw(path):
    """The card's machine has none of pandas, tensorboardX and
    matplotlib: no port module imports the first two, and matplotlib is
    imported only inside the functions that draw (`DRAWERS`:
    `eval/visualize.draw` and `eval/tables._draw_svg`)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    drawer = DRAWERS.get(path)

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, child.name)
                continue
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in child.names] if isinstance(child, ast.Import)
                         else [child.module or ""])
                for n in names:
                    top = n.split(".")[0]
                    if top in HOST_ONLY:
                        assert top == "matplotlib" and func is not None and func == drawer, \
                            f"{path.name}:{child.lineno} imports {n} (in {func})"
            walk(child, func)

    walk(tree, None)


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


@pytest.mark.parametrize("channels,refused", [(36, False), (312, False), (313, True)])
def test_warp_row_guard_at_the_flagship_size(channels, refused):
    """The warp and df-cotangent kernels address a row in 32 bits: at
    160x192x224 a moving map of up to 312 channels passes the guard (the
    36-channel one-hot map with room to spare), 313 do not. Decided from
    the shapes alone, before anything is allocated or launched."""
    from pulpo_tpu_torch.kernels import warp

    size = (160, 192, 224)
    assert warp.max_channels(size) == 312
    moving, df = (1, *size, channels), (1, *size, 3)
    if refused:
        with pytest.raises(ValueError, match=r"32 bits.*at most 312 channels at \(160, 192, 224\)"):
            warp.check_rows(moving, df)
    else:
        warp.check_rows(moving, df)
