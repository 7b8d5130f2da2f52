"""The benchmark's harness, driven by data.

A cell (an entry of BENCHMARK.json's `workloads`) is found by its name:
`workloads/<cell>.json` names its configuration and traffic and holds
its correctness limits; `configs/<config>.json` holds the
configuration's `model` dict and the peak its `mfu` divides by; `traffic/<traffic>.json` holds the traffic's
parameters and names its `kind`, whose driver is `kinds/<kind>.py`;
every metric is read by `metrics/<metric>.py`
(`read(run) -> float | None`). A new configuration, traffic mix, cell
or metric is a new file and an entry in BENCHMARK.json.

`execute` runs one cell: set-up (weights and pool from the seed, the
port's model, warm-up), the measured window, the reading of the
metrics, the comparison with the reference, the result line's object.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pulpo_tpu")

# the port's launch counters: kernel id -> (module, attribute)
COUNTERS = {
    "conv_chain": ("pulpo_tpu_torch.kernels.conv_chain", "launches"),
    "pos_head": ("pulpo_tpu_torch.kernels.pos_head", "launches"),
    "vel_head": ("pulpo_tpu_torch.kernels.vel_head", "launches"),
    "squaring": ("pulpo_tpu_torch.kernels.squaring", "launches"),
    "squaring_cf": ("pulpo_tpu_torch.kernels.squaring", "cf_launches"),
    "squaring_bwd": ("pulpo_tpu_torch.kernels.squaring", "bwd_launches"),
    "warp": ("pulpo_tpu_torch.kernels.warp", "launches"),
    "warp_cf": ("pulpo_tpu_torch.kernels.warp", "cf_launches"),
    "warp_dfgrad": ("pulpo_tpu_torch.kernels.warp", "dfgrad_launches"),
    "box_sum": ("pulpo_tpu_torch.kernels.box_sum", "launches"),
    "conv_narrow": ("pulpo_tpu_torch.kernels.conv_narrow", "launches"),
}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(kind: str, name: str, bench_dir: Path = BENCH) -> Path:
    """The file of a configuration, traffic mix, cell or metric by name."""
    sub, ext = {"config": ("configs", ".json"), "traffic": ("traffic", ".json"),
                "workload": ("workloads", ".json"), "metric": ("metrics", ".py"),
                "kind": ("kinds", ".py")}[kind]
    path = bench_dir / sub / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    spec: dict       # workloads/<cell>.json
    config: dict     # configs/<config>.json
    traffic: dict    # traffic/<traffic>.json
    model: dict      # the configuration's model dict, as run


def cell(name: str, bench_dir: Path = BENCH, model_overrides: dict | None = None) -> Cell:
    spec = load_json(find("workload", name, bench_dir))
    config = load_json(find("config", spec["config"], bench_dir))
    traffic = load_json(find("traffic", spec["traffic"], bench_dir))
    model = dict(config["model"], **(model_overrides or {}))
    return Cell(name, spec, config, traffic, model)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    a trace its per-layer ones (those listing it, or without a list,
    those moving an end-to-end metric it reports)."""
    mine = lambda m: cell_name in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]


@dataclass
class Run:
    """What a run measured, as the metric readers see it. `units` and
    `window_s` are the untraced window's (in a traced run, the window
    before the traced one); `traced_units` the traced window's."""
    cell: Cell
    kind: str
    units: int = 0                   # requests or steps completed in the untraced window
    window_s: float = 0.0
    setup_s: float = 0.0
    peak_bytes: int = 0
    latencies_s: list = field(default_factory=list)
    traced_units: int = 0            # requests or steps completed in the traced window
    counts: dict | None = None       # launches of the port's kernels in the window (traced)
    trace: object | None = None      # trace.Trace of the window (traced)
    info: dict = field(default_factory=dict)


def read_counts() -> dict[str, int]:
    return {k: int(getattr(importlib.import_module(mod), attr))
            for k, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    for mod in {m for m, _ in COUNTERS.values()}:
        importlib.import_module(mod).reset_count()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(name: str, seed: int, seconds: float, trace: bool, device="cuda",
            start: float | None = None, bench_dir: Path = BENCH, root: Path = ROOT,
            model_overrides: dict | None = None, log=print, program: str = "port",
            max_units: float = float("inf"), readings: dict | None = None,
            limits: dict | None = None) -> dict:
    """One run of the cell `name`; returns the result line's object.
    `program` other than "port" puts the reference, in that precision, in
    the port's place (the control); `max_units` caps the run's requests
    or steps (the control's readings); `readings` receives every number
    the cell's comparison computed, compared or not; `limits` the cell's
    correctness limits (the tests, at a size other than the cell's).

    A traced run measures two windows of the traffic's `trace_seconds`
    (at most `seconds`): an untraced one, whose rate the `mfu` metrics
    read, then one under the profiler, which the others read."""
    from portbench import trace as tracing

    start = time.perf_counter() if start is None else start
    c = cell(name, bench_dir, model_overrides)
    kind_name = c.traffic["kind"]
    kind = load_module(find("kind", kind_name, bench_dir))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    drv = kind.Driver(c.model, c.traffic, seed, dev, program)
    drv.setup()
    run = Run(c, kind_name)
    run.setup_s = time.perf_counter() - start
    length = min(seconds, float(c.traffic.get("trace_seconds", seconds))) if trace else seconds

    def window(first: int, spans: list | None = None) -> tuple[int, float]:
        """Requests or steps from index `first` until `length` seconds have
        passed, each a host span in `spans`; (their number, the seconds)."""
        t0 = time.perf_counter()
        n = 0
        while first + n < max_units:
            s = time.perf_counter()
            drv.run_unit(first + n)
            n += 1
            e = time.perf_counter()
            if spans is not None:
                spans.append((kind.SPAN, s, e))
            if e - t0 >= length:
                break
        sync()
        return n, time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    run.units, run.window_s = window(0)
    n = run.units
    if trace:
        if not cuda:
            raise ValueError("a traced run needs the card")
        reset_counts()
        spans: list = []
        prof = tracing.profiler()
        prof.__enter__()
        try:
            sync()
            host_lo = time.perf_counter()
            run.traced_units, traced_s = window(n, spans)
        finally:
            prof.__exit__(None, None, None)
        n += run.traced_units
        run.counts = read_counts()
        run.trace = tracing.Trace(prof, spans, host_lo)
        del prof
        run.info.update(untraced_ms_per_unit=1e3 * run.window_s / max(run.units, 1),
                        traced_ms_per_unit=1e3 * traced_s / max(run.traced_units, 1))
    drv.finish(n)
    run.latencies_s = list(getattr(drv, "latencies", []))
    run.peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.compare()
    run.info.update(drv.info)
    if readings is not None:
        readings.update(numbers)
    limits = c.spec["limits"] if limits is None else limits
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())  # NaN is not correct
    bench = benchmark(root)
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = load_module(find("metric", m["name"], bench_dir)).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                "count": 1, "memory_peak_bytes": run.peak_bytes}
    if trace:
        dev_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    log(f"portbench: {name} seed {seed}: {run.units} {kind.UNIT} in {run.window_s} s"
        + (f", then {run.traced_units} traced in {run.trace.window_s} s" if trace else "")
        + f", set-up {run.setup_s} s, {json.dumps(run.info)}")
    result = {"correct": bool(correct), "attempted": n, "failed": int(drv.failed),
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["compared"] = compared
    return result
