"""UQ requests: N-sample uncertainty predictions, one client, a closed loop.

The window's entry is the port's
`uq.predict.predict_with_uncertainty(model, x, y, N, seed, chunk)`: a
request is sent when the previous one has finished (its leaves computed:
the host waits for the card), on the next pair of the pool, with its own
seed. Set-up makes the weights and the pool from the run's seed, builds
the kernels, loads the model and answers one warm-up request, which
also measures the port's chunk fit.

Checked: two requests of the window, the one with an index drawn from
the seed among the first `check_first` and the last one; every
`UQResult` leaf, by level, against the plain reference's
(`reference.pulpo_ref.uq_request`), worst leaf by `compare.rel_gap`.

Traffic keys: `n_samples`, `chunk` (null: the port's own memory fit),
`pool`, `check_first`, `trace_seconds`.
"""

from __future__ import annotations

import time

import torch

from portbench import compare, pool
from portbench.reference import pulpo_ref as R

SPAN = "request"
UNIT = "requests"
LEAVES = ("mean_outputs", "avg_dfs", "final_dfs", "outputs", "output_std",
          "individual_df_std", "final_df_std", "output_mse", "output_entropy")


def port_config(model: dict):
    from pulpo_tpu_torch import PULPoConfig

    return PULPoConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})


class Driver:
    """One run of the kind. `program`: "port", or a precision of the
    reference put in the port's place (the control)."""

    def __init__(self, model: dict, traffic: dict, seed: int, device, program: str = "port"):
        self.m, self.t, self.seed = model, traffic, int(seed)
        self.dev = torch.device(device)
        self.program = program
        self.N = int(traffic["n_samples"])
        self.chunk = traffic.get("chunk")
        self.latencies: list[float] = []
        self.kept: dict[int, tuple] = {}
        self.failed = 0
        self.info: dict = {}

    def request_seed(self, i: int) -> int:
        return pool.derive(self.seed, "request", i)

    def setup(self) -> None:
        self.weights = pool.make_weights(self.m, self.seed, self.dev)
        self.pairs = pool.make_pairs(tuple(self.m["input_size"]), int(self.t["pool"]),
                                     self.seed, self.dev)
        self.check = pool.derive(self.seed, "check") % int(self.t["check_first"])
        if self.program == "port":
            from pulpo_tpu_torch.models import PULPoModel
            from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

            if self.dev.type == "cuda":
                from pulpo_tpu_torch.kernels import _build

                _build.build_all()
            self.model = PULPoModel(port_config(self.m), device=self.dev)
            self.model.load_state_dict(self.weights)
            self._predict = lambda x, y, s: predict_with_uncertainty(
                self.model, x, y, self.N, seed=s, chunk=self.chunk)
        else:
            self._predict = self._control
        x, y = self.pairs[0]
        res = self._predict(x, y, pool.derive(self.seed, "warm-up"))
        self.first = int(res["outputs"][0].shape[1] if isinstance(res, dict)
                         else res.outputs[0].shape[1])
        self.info.update(chunk=self.first, pool=len(self.pairs), n_samples=self.N)
        self._sync()

    def _control(self, x, y, s):
        first = self.chunk or self.N
        return R.uq_request(self.m, self.weights, x, y, self.N, s, first, self.program)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run_unit(self, i: int) -> None:
        x, y = self.pairs[i % len(self.pairs)]
        t = time.perf_counter()
        res = self._predict(x, y, self.request_seed(i))
        self._sync()
        self.latencies.append(time.perf_counter() - t)
        if i == self.check:
            self.kept[i] = res
        self.last = (i, res)

    def finish(self, units: int) -> None:
        if units:
            i, res = self.last
            self.kept[i] = res
        self.last = None

    def release(self) -> None:
        self.model = self._predict = None

    def compare(self) -> dict[str, float]:
        """The worst leaf's relative gap over the checked requests."""
        worst = 0.0
        for i, res in sorted(self.kept.items()):
            x, y = self.pairs[i % len(self.pairs)]
            ref = R.uq_request(self.m, self.weights, x, y, self.N, self.request_seed(i),
                               self.first)
            for leaf in LEAVES:
                got = res[leaf] if isinstance(res, dict) else getattr(res, leaf)
                for l, r in ref[leaf].items():
                    gap = compare.rel_gap(got[l], r) if l in got else float("inf")
                    if not gap <= worst:
                        worst = gap
                        self.info["worst_leaf"] = f"request {i} {leaf}[{l}]"
            del ref
        self.info["checked_requests"] = sorted(self.kept)
        return {"uq_leaf_gap": worst}
