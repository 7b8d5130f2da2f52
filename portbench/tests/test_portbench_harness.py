"""The harness on the CPU: discovery by name, a cell and a metric added as
files, the import rule, the result line's keys, the trace arithmetic,
the names' characters, and runs with the timed path broken underneath
(each must come out not correct), at a tiny size."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, TINY, TINY_LIMITS
from portbench import harness, trace
from portbench.work import groups

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}
FORBIDDEN = {"jax", "jaxlib", "flax", "pulpo_tpu"}


def run(cell, seed=2**31 + 7, seconds=0.3, trace_on=False, **kw):
    return harness.execute(cell, seed, seconds, trace_on, device="cpu", model_overrides=TINY,
                           log=lambda s: None, limits=TINY_LIMITS.get(cell), **kw)


# ----------------------------------------------------------------------
# discovery and the manifest

def test_every_configuration_cell_and_metric_is_found_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.load_json(ROOT / c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = harness.cell(w["name"])
        assert (cell.spec["config"], cell.spec["traffic"]) == (w["config"], w["traffic"])
        harness.find("kind", cell.traffic["kind"])
        for m in harness.metrics_of(BENCH, w["name"], False) + harness.metrics_of(
                BENCH, w["name"], True):
            assert callable(harness.load_module(harness.find("metric", m["name"])).read)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        harness.find("metric", m["name"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.metrics_of(BENCH, w["name"], True)
        assert per and all(m["moves"] in e2e for m in per)


def test_names_units_and_lengths_keep_to_the_manifest_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["reduced"] == []
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


def test_a_cell_and_a_metric_added_as_files_only_are_picked_up(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_dir = tmp_path / "portbench"
    (bench_dir / "traffic" / "uq8.json").write_text(json.dumps(dict(
        harness.load_json(bench_dir / "traffic" / "uq32.json"), n_samples=8)))
    (bench_dir / "workloads" / "oasis-uq8.json").write_text(json.dumps(dict(
        harness.load_json(bench_dir / "workloads" / "oasis-uq32.json"), traffic="uq8")))
    (bench_dir / "metrics" / "requests_seen.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "oasis-uq8", "config": "pulpo-oasis-3d-bf16",
                               "traffic": "uq8", "chips": 1, "why": "a throwaway cell"})
    bench["end_to_end"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["oasis-uq8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run("oasis-uq8", bench_dir=bench_dir, root=tmp_path)
    assert res["metrics"]["requests_seen"]["value"] == res["attempted"] >= 1
    assert res["correct"] is True


# ----------------------------------------------------------------------
# imports

def roots(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_benchmark_file_imports_jax_flax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" not in path.parts:
            assert not roots(path) & FORBIDDEN, path


def test_top_level_names_are_compared_whole():
    sys.modules.setdefault("pulpo_tpu_torch_lookalike", SimpleNamespace())
    try:
        assert "pulpo_tpu_torch_lookalike" not in harness.forbidden_modules()
        assert "pulpo_tpu_torch" not in harness.FORBIDDEN
    finally:
        sys.modules.pop("pulpo_tpu_torch_lookalike", None)


def test_a_run_loads_no_jax_module():
    code = ("import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import TINY\nfrom portbench import harness\n"
            "harness.execute('oasis-train', 3, 0.1, False, device='cpu', model_overrides=TINY,"
            " log=lambda s: None)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), str(ROOT / "portbench" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "pulpo_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_without_a_card_the_command_exits_with_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "oasis-uq32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


# ----------------------------------------------------------------------
# the result line and the trace arithmetic

def test_the_result_has_the_contract_keys_and_the_compared_numbers_last():
    res = run("oasis-uq32")
    assert set(res) == RESULT_KEYS and list(res)[-1] == "compared"
    assert set(res["device"]) == DEVICE_KEYS
    assert {"uq_pairs_per_s", "uq_latency_p90_ms", "setup_s"} <= set(res["metrics"])
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


def test_busy_union_idle_gaps_and_groups_on_made_up_events():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert groups.union(iv) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert groups.busy(iv, 1.0, 10.0) == pytest.approx(1.0 + 1.0 + 1.0)
    assert groups.gaps(iv, 1.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert groups.group_of("void (anonymous namespace)::conv_unit_tc<96>(...)") == "own"
    assert groups.group_of("void fixed::convert(long long const*, float*)") == "own"
    assert groups.group_of("cudnn::implicit_convolve_sgemm") == "conv"
    assert groups.group_of("nvjet_tst_128x64") == "gemm"
    assert groups.group_of("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"


class FakeProfile:
    """What `trace.Trace` reads of a profiler: raw events."""

    class Ev:
        def __init__(self, name, dev, s, d):
            self._n, self._dev, self._s, self._d = name, dev, s, d

        def name(self):
            return self._n

        def device_type(self):
            return self._dev

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def is_user_annotation(self):
            return self._n == "step"

    def __init__(self, events):
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        evs = [self.Ev(n, cpu if d == "cpu" else cuda, s, t) for n, d, s, t in events]
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: evs))


def test_the_trace_reduction_on_made_up_events():
    ms = 1_000_000
    prof = FakeProfile([
        # the window: from the end of the opening synchronisation to the end of the closing one
        ("cudaDeviceSynchronize", "cpu", -2 * ms, 2 * ms),
        ("cudaDeviceSynchronize", "cpu", 95 * ms, 5 * ms),
        ("step", "cuda", 0, 50 * ms),  # a span's mirror on the device timeline, not an operation
        ("cudaStreamSynchronize", "cpu", 40 * ms, 10 * ms),
        ("void squaring_kernel<0>", "cuda", 5 * ms, 20 * ms),
        ("nvjet_gemm", "cuda", 20 * ms, 20 * ms),
        ("void at::native::vectorized_elementwise_kernel", "cuda", 60 * ms, 30 * ms),
        ("before the window", "cuda", -10 * ms, 5 * ms),
    ])
    # the host's spans on its own clock, 7 s behind the profiler's
    t = trace.Trace(prof, [("step", 7.0, 7.05), ("step", 7.05, 7.1)], host_lo=7.0)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.065)
    assert t.group_seconds("own") == pytest.approx(0.02)
    assert t.matching_seconds(("squaring_kernel",)) == pytest.approx(0.02)
    assert t.top_ops()[0] == ["void at::native::vectorized_elementwise_kernel",
                              pytest.approx(0.03)]
    # idle: [0, 5) as the opening synchronisation ends, [40, 60) while a
    # stream synchronises, [90, 100) with no runtime call
    assert dict(t.idle_gaps()) == {"step:cudaDeviceSynchronize": pytest.approx(0.005),
                                   "step:cudaStreamSynchronize": pytest.approx(0.02),
                                   "step:python": pytest.approx(0.01)}


def test_a_trace_without_the_window_synchronisations_is_refused():
    prof = FakeProfile([("void squaring_kernel<0>", "cuda", 0, 10)])
    with pytest.raises(RuntimeError):
        trace.Trace(prof, [], host_lo=0.0)


def test_per_layer_metrics_read_a_made_up_traced_run():
    cell = harness.cell("oasis-train")
    fake = SimpleNamespace(busy_s=0.5, window_s=1.0,
                           group_seconds=lambda g: {"conv": 0.2, "elementwise": 0.1}.get(g, 0),
                           matching_seconds=lambda pats: 0.004)
    counts = {"conv_narrow": 10, "squaring": 56, "squaring_bwd": 56, "warp": 8,
              "warp_dfgrad": 8, "box_sum": 64}
    r = harness.Run(cell, "train", units=4, window_s=2.0, traced_units=2, counts=counts,
                    trace=fake)
    read = lambda name: harness.load_module(harness.find("metric", name)).read(r)
    assert read("idle_share.train") == pytest.approx(50.0)
    assert read("conv_ms.train") == pytest.approx(100.0)
    assert read("elementwise_ms.train") == pytest.approx(50.0)
    from portbench.work import flops

    assert read("mfu.train") == pytest.approx(
        100 * 4 * flops.train_step(cell.model, 1) / (2.0 * cell.config["mfu_peak_flops"]))
    roof = read("kernel_roofline.train")
    from portbench.work import kernel_ops

    least = sum(d["least_s"] for d in kernel_ops.least_by_kernel(
        kernel_ops.train_step(cell.model, 1)).values())
    assert roof == pytest.approx(100 * 2 * least / 0.004)
    assert read("idle_share.uq") is None and read("gemm_ms.uq") is None
    assert read("mfu.uq") is None


# ----------------------------------------------------------------------
# the comparison fails what it should

def test_sound_tiny_runs_are_correct():
    for cell in ("oasis-uq32", "oasis-train", "brats-train-f32"):
        assert run(cell)["correct"] is True, cell


def unchanged_step(vec, *args, **kw):
    return vec


@pytest.mark.parametrize("fault", ["squaring step returns its state", "output std altered"])
def test_a_broken_uq_request_is_not_correct(monkeypatch, fault):
    from pulpo_tpu_torch.kernels import squaring
    from pulpo_tpu_torch.uq import predict

    if fault == "squaring step returns its state":
        monkeypatch.setattr(squaring, "squaring_step_plain", unchanged_step)
    else:
        std = predict._finalize_std
        monkeypatch.setattr(predict, "_finalize_std", lambda m, n: 2 * std(m, n))
    assert run("oasis-uq32")["correct"] is False


@pytest.mark.parametrize("cell", ["oasis-train", "brats-train-f32"])
@pytest.mark.parametrize("fault", ["state unchanged", "loss altered"])
def test_a_broken_training_step_is_not_correct(monkeypatch, cell, fault):
    from pulpo_tpu_torch.models.api import PULPoModel
    from pulpo_tpu_torch.ops import losses
    from pulpo_tpu_torch.train import step

    if fault == "state unchanged":
        monkeypatch.setattr(step.Adam, "update", lambda self, g, s, p: None)
        monkeypatch.setattr(PULPoModel, "commit_batch_stats", lambda self, stats: None)
    else:
        ncc = losses.ncc_loss
        monkeypatch.setattr(losses, "ncc_loss", lambda *a, **k: 1.5 * ncc(*a, **k))
    res = run(cell)
    assert res["correct"] is False
    if fault == "state unchanged":
        assert res["compared"]["change_p90_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell, control", [("oasis-uq32", "float8"),
                                           ("oasis-train", "float8"),
                                           ("brats-train-f32", "bfloat16")])
def test_the_control_in_a_lower_precision_is_not_correct(cell, control):
    units = 0 if harness.cell(cell).traffic["kind"] == "train" else 2
    res = run(cell, seconds=float("inf"), program=control, max_units=units)
    assert res["correct"] is False


@pytest.mark.gpu
def test_the_bfloat16_control_fails_the_float32_cell_on_the_card(card):
    """The float32 cell's convs run in TF32, PyTorch's default; its control
    is the reference in bfloat16, at the cell's own size."""
    res = harness.execute("brats-train-f32", 9, float("inf"), False, device="cuda",
                          log=lambda s: None, program="bfloat16", max_units=0)
    assert res["correct"] is False


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(card):
    res = harness.execute("oasis-uq32", 5, 1.0, True, device="cuda", model_overrides=TINY,
                          log=lambda s: None)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and "mfu.uq" in res["metrics"]
