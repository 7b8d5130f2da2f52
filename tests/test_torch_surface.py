"""The port's package surface against the JAX package's, on the CPU.

- Every name that a JAX subpackage's `__init__.py` re-exports (ops, uq,
  eval, data, train, models, parallel) resolves on the port's package
  of the same name, as a module where the JAX name is a module.
- Importing those packages in a fresh interpreter loads neither
  matplotlib nor h5py (the card's machine has neither), nor JAX, and
  starts no process (no kernel is built at import).
- `ops.avg_pool_pyramid` and `ops.warp.resize_dfs` against the JAX functions
  on seeded numpy inputs: within 1e-6 of each output's scale (the same
  resize matrices; float32 matmuls summed in another order).
- `eval.tables.make_tables`' SVG: the same text, in the same order, as
  the JAX `make_tables`' SVG of the same table (matplotlib writes each
  text element's string as a comment beside its glyphs).
- A tiny `train_cli` run evaluates with the figures, as the JAX CLI does:
  each loader's three figures as `.npz` panels and `.png`, and the
  tables' `.svg`.
"""

import ast
import importlib
import json
import pathlib
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.eval import tables as jax_tables
from pulpo_tpu.ops.resize import avg_pool_pyramid as jax_avg_pool_pyramid
from pulpo_tpu.ops.warp import resize_dfs as jax_resize_dfs
from pulpo_tpu_torch import train_cli
from pulpo_tpu_torch.eval import tables
from pulpo_tpu_torch.ops import avg_pool_pyramid
from pulpo_tpu_torch.ops.warp import resize_dfs
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("ops", "uq", "eval", "data", "train", "models", "parallel")


def jax_reexports(package: str) -> list[str]:
    """The names `pulpo_tpu/<package>/__init__.py` imports."""
    tree = ast.parse((ROOT / "pulpo_tpu" / package / "__init__.py").read_text())
    return [a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_reexport_resolves_on_the_port(package):
    names = jax_reexports(package)
    assert names, package
    jax_pkg = importlib.import_module(f"pulpo_tpu.{package}")
    port = importlib.import_module(f"pulpo_tpu_torch.{package}")
    for name in names:
        got = getattr(port, name)
        assert isinstance(got, types.ModuleType) == isinstance(getattr(jax_pkg, name),
                                                               types.ModuleType), name
        assert name in port.__all__, (package, name)


def test_the_packages_import_without_matplotlib_h5py_or_a_build():
    code = f"""
import json, subprocess, sys
started = []
class Spy(subprocess.Popen):
    def __init__(self, args, *a, **k):
        started.append(str(args))
        super().__init__(args, *a, **k)
subprocess.Popen = Spy
for p in {PACKAGES!r}:
    __import__("pulpo_tpu_torch." + p)
from pulpo_tpu_torch.kernels import _build
loaded = [m for m in ("matplotlib", "h5py", "jax", "flax", "pulpo_tpu") if m in sys.modules]
print(json.dumps({{"loaded": loaded, "started": started, "libs": sorted(_build._LIBS)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "loaded": [], "started": [], "libs": []}


def test_avg_pool_pyramid_matches_jax():
    x = np.random.default_rng(0).random((2, 13, 14, 9, 2), dtype=np.float32)
    got = avg_pool_pyramid(torch.from_numpy(x), 4)
    want = jax_avg_pool_pyramid(jnp.asarray(x), 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max())


@pytest.mark.parametrize("target", [None, (20, 18, 16)], ids=["level0", "target"])
def test_resize_dfs_matches_jax(target):
    rng = np.random.default_rng(1)
    sizes = {0: (16, 14, 12), 1: (8, 7, 6), 2: (4, 4, 3)}
    dfs = {l: rng.standard_normal((1, *s, 3)).astype(np.float32) for l, s in sizes.items()}
    got = resize_dfs({l: torch.from_numpy(v) for l, v in dfs.items()}, target)
    want = jax_resize_dfs({l: jnp.asarray(v) for l, v in dfs.items()}, target)
    assert list(got) == list(want) == [0, 1, 2]
    for l, w in want.items():
        w = np.asarray(w)
        assert got[l].shape == w.shape == (1, *(target or sizes[0]), 3)
        assert float(np.abs(got[l].numpy() - w).max()) <= 1e-6 * float(np.abs(w).max()), l


def _svg_text(path: pathlib.Path) -> list[str]:
    return re.findall(r"<!-- (.*?) -->", path.read_text())


def test_the_table_svg_carries_the_jax_svg_cells(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    data = rng.random((4, 3, 2))
    data[0, 0, 0], data[1, 2, 1], data[2, 1, 0] = 3e-4, np.nan, 12.5
    sets, metrics_ = ["train", "val"], ["RMSE", "NCC", "Dice", "JDetLeq0"]
    jax_tables.make_tables(jax_tables.multiindex_table(data, sets, metrics_, [0, 1, 2]),
                           tmp_path, name="jax")
    tables.make_tables(tables.multiindex_table(data, sets, metrics_, [0, 1, 2]), tmp_path,
                       name="port")
    want = _svg_text(tmp_path / "jax.svg")
    assert len(want) == 3 * 8 + 3 + 8 and "3.00e-04" not in want  # rounded to 0.0 first
    assert _svg_text(tmp_path / "port.svg") == want
    assert {p.name for p in tmp_path.iterdir()} >= {"port.csv", "port.tex", "port.svg"}


def test_a_tiny_train_cli_run_writes_its_figures(tmp_path):
    pytest.importorskip("matplotlib")
    run_dir = train_cli.main([
        "--dataset", "synthetic", "--accelerator", "cpu", "--max_steps", "1", "--n0", "2",
        "--total_levels", "3", "--latent_levels", "2",
        "--run_dir", str(tmp_path)])
    out = run_dir / "evaluation"
    figures = [f"allvis{s}_{p}" for s in ("train", "val", "test")
               for p in ("deterministic", "sample", "avg_10")]
    assert sorted(f.name for f in (out / "vis").iterdir()) == sorted(
        f + ext for f in figures for ext in (".npz", ".png"))
    for sub in ("jdet", "loss"):
        svgs = sorted(out.glob(f"{sub}/*.svg"))
        assert svgs and [p.with_suffix(".csv").exists() for p in svgs] == [True] * len(svgs)
