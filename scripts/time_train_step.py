#!/usr/bin/env python3
"""Time the flagship, LungCT-shaped and flagship-2d training steps of a
checkout on the card.

    cd <checkout> && python3 <this repo>/scripts/time_train_step.py TAG

The working directory's `chip_smoke.py` and `pulpo_tpu_torch` are the
ones timed, so one copy of the script times any checkout.

Builds every kernel, then takes 1 warm-up and 12 timed B = 1 steps of
each configuration (the flagship network also on LungCT's 192x192x208
volume, a synthetic pair) through `chip_smoke.run_train_path` (exact
launch counts checked) and prints `AB TAG flagship_step <s>
lungct_step <s> step_2d <s>`, the means. Run it from two checkouts in alternating processes (A B B A ...)
to compare their steps on one card.
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from pulpo_tpu_torch.kernels import _build  # noqa: E402

_build.build_all()
tag = sys.argv[1]
_, r = cs.run_train_path("cuda", cs.FLAGSHIP, 12)
_, rl = cs.run_train_path("cuda", dict(cs.FLAGSHIP, input_size=cs.LUNGCT["input_size"]), 12)
_, r2 = cs.run_train_path("cuda", cs.FLAGSHIP_2D, 12)
print(f"AB {tag} flagship_step {r['step_s']:.5f} lungct_step {rl['step_s']:.5f} "
      f"step_2d {r2['step_s']:.5f}", flush=True)
