"""Arithmetic shared by the metric readers (`metrics/<name>.py`), each of
which returns its number, or None where its run has nothing to read."""

from __future__ import annotations

import math

from portbench.work import flops, kernel_ops


def traced(run, kind: str) -> bool:
    """A traced run of this kind in which the device ran something."""
    return (run.trace is not None and run.kind == kind and run.traced_units > 0
            and run.trace.busy_s > 0)


def idle_share(run, kind: str):
    """Percent of the traced window in which no operation ran on the device."""
    if not traced(run, kind):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def group_ms(run, kind: str, group: str):
    """Device ms a request or step in one kernel group."""
    if not traced(run, kind):
        return None
    return 1e3 * run.trace.group_seconds(group) / run.traced_units


def unit_flops(run) -> int:
    m, t = run.cell.model, run.cell.traffic
    if run.kind == "uq":
        return flops.uq_request(m, int(t["n_samples"]))
    return flops.train_step(m, int(t["batch"]))


def mfu(run, kind: str):
    """Percent of the configuration's peak: the conv FLOPs of the untraced
    window's requests or steps over its length, in a traced run (the
    window before the traced one: no profiler slows it)."""
    if not traced(run, kind) or run.units == 0:
        return None
    peak = float(run.cell.config["mfu_peak_flops"])
    return 100.0 * unit_flops(run) * run.units / (run.window_s * peak)


def unit_ops(run) -> list:
    m, t = run.cell.model, run.cell.traffic
    if run.kind == "uq":
        return kernel_ops.uq_request(m, int(t["n_samples"]), int(run.info["chunk"]))
    return kernel_ops.train_step(m, int(t["batch"]))


def kernel_roofline(run, kind: str, patterns):
    """Percent: the least time of the operations the port's kernels ran in
    the traced window (each kernel's least time a launch, from the
    configuration's shapes, times its counted launches) over the device
    time of the kernels whose names hold one of `patterns`."""
    if not traced(run, kind) or run.counts is None:
        return None
    least = 0.0
    for k, d in kernel_ops.least_by_kernel(unit_ops(run)).items():
        least += d["least_s"] / d["launches"] * run.counts.get(k, 0)
    spent = run.trace.matching_seconds(patterns)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
