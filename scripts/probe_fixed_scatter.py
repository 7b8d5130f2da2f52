#!/usr/bin/env python3
"""Where the fixed-point scatters' time goes, on the card.

    python3 scripts/probe_fixed_scatter.py [--json PATH]

At phase 6's shape (level 0, 80x96x112, C = 3, a smooth 3-voxel field,
one row) it times, by CUDA-graph replay (chip_smoke.graph_ms):
- the squaring backward (#2, csrc/squaring_bwd.cu) whole, and each of
  its three phases alone through its entry's phase mask: 1 (the int64
  buffer zeroed and the max |g| pass), 2 (the march) and 4 (the convert
  pass);
- the march of #2 and the whole moving-cotangent (#7, csrc/warp_bwd.cu)
  built from copies of this checkout's sources with one thing changed in
  csrc/fixed.cuh: `no_atomics` (a term is added only if it equals a value
  no term takes, so the terms are still formed), `red32` (each term's
  low 32 bits added with a 32-bit integer atomic), `red_f32` (the term
  converted to float and added with a float atomic) and `no_y_merge`
  (the exchange between the tile's lines turned off; the z and x merges
  stay). The outputs of these copies are wrong by construction and not
  compared; `as_built` is the unchanged source, which is;
and prints each build's registers a thread and the shared-memory atomic
instructions sm_90 gives a 64-bit and a 32-bit integer add (cuobjdump
of a small kernel): whether a shared-memory window could merge int64
terms natively. Prints the card's name and power limit. Needs a CUDA
device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

ADD = "if (v != 0) atomicAdd(p, (unsigned long long)v);"
TAKE_Y = "if (have && line + 1 < lines && sh.key[0][up] == i0[0]"
GIVE_Y = "const bool given = have && line > 0 &&"
VARIANTS = {
    "as_built": [],
    "no_atomics": [(ADD, "if (v == 0x123456789LL) atomicAdd(p, (unsigned long long)v);")],
    "red32": [(ADD, "if (v != 0) atomicAdd(reinterpret_cast<unsigned*>(p), (unsigned)v);")],
    "red_f32": [(ADD, "if (v != 0) atomicAdd(reinterpret_cast<float*>(p), (float)v);")],
    "no_y_merge": [(TAKE_Y, TAKE_Y.replace("if (have", "if (false && have")),
                   (GIVE_Y, GIVE_Y.replace("= have", "= false && have"))],
}
SHARED_ADDS = r"""
__global__ void add64(unsigned long long* o, long long v) {
  __shared__ unsigned long long s[256];
  s[threadIdx.x] = 0; __syncthreads();
  atomicAdd(&s[(threadIdx.x * 7) & 255], (unsigned long long)v);
  __syncthreads(); o[threadIdx.x] = s[threadIdx.x]; }
__global__ void add32(unsigned* o, int v) {
  __shared__ unsigned s[256];
  s[threadIdx.x] = 0; __syncthreads();
  atomicAdd(&s[(threadIdx.x * 7) & 255], (unsigned)v);
  __syncthreads(); o[threadIdx.x] = s[threadIdx.x]; }
"""


def build_variants(root: str, out_dir: str) -> dict:
    """{variant: {kernel: (library, registers)}}: this checkout's
    squaring_bwd.cu and warp_bwd.cu built with each variant's fixed.cuh,
    one nvcc per library, all started together."""
    from pulpo_tpu_torch.kernels import _build

    csrc = os.path.join(root, "pulpo_tpu_torch", "csrc")
    started = []
    for name, edits in VARIANTS.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        for f in ("gather.cuh", "fixed.cuh", "squaring_bwd.cu", "warp_bwd.cu"):
            shutil.copy(os.path.join(csrc, f), d)
        path = os.path.join(d, "fixed.cuh")
        text = open(path).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: '{old}' not found once in fixed.cuh")
            text = text.replace(old, new)
        open(path, "w").write(text)
        for kernel in ("squaring_bwd", "warp_bwd"):
            lib = os.path.join(d, f"lib{kernel}.so")
            cmd = [_build._nvcc(), os.path.join(d, f"{kernel}.cu"), *_build.BASE_FLAGS,
                   *_build.SOURCES[kernel][1], "-o", lib]
            started.append((name, kernel, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, kernel, lib, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}/{kernel}:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        libs.setdefault(name, {})[kernel] = (ctypes.CDLL(lib), regs)
    return libs


def shared_atomics(out_dir: str) -> list[str]:
    """The SASS atomic instructions of a 64-bit and a 32-bit integer add
    into shared memory, for sm_90a."""
    from pulpo_tpu_torch.kernels import _build

    src, cubin = os.path.join(out_dir, "shared_adds.cu"), os.path.join(out_dir, "shared_adds.cubin")
    open(src, "w").write(SHARED_ADDS)
    subprocess.run([_build._nvcc(), "-cubin", "-arch=sm_90a", "-o", cubin, src], check=True)
    nvcc_dir = os.path.dirname(_build._nvcc())
    sass = subprocess.run([os.path.join(nvcc_dir, "cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    return sorted(set(re.findall(r"ATOMS\.[A-Z0-9.]+", sass)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_fixed_scatter: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import card_line, graph_ms, smooth_field
    from pulpo_tpu_torch.kernels import gather, squaring, warp

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    size = (80, 96, 112)
    n_vox = math.prod(size)
    shape = (1, *size, 3)
    v = smooth_field(1, size, 3.0, seed=33, device=dev)
    g = torch.randn(shape, device=dev)
    out = torch.empty(shape, device=dev)
    work = torch.empty(v.numel() + 1, device=dev, dtype=torch.int64)
    plan = gather.plan_arg(gather.squaring_bwd_plan(size, 1))
    mplan = gather.plan_arg(warp.mgrad_plan(shape))
    f = [warp._factor(s, s) for s in size]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def bwd(lib, phases):
        fn = lib.pulpo_squaring_step_bwd
        fn.argtypes = [P] * 4 + [I] * 4 + [F] * 3 + [P, I, P]
        rc = fn(v.data_ptr(), g.data_ptr(), out.data_ptr(), work.data_ptr(), 1, *size, *f, plan,
                phases, stream())
        assert rc == 0, rc

    def mgrad(lib):
        fn = lib.pulpo_warp_mgrad
        fn.argtypes = [P] * 4 + [I] * 9 + [F] * 3 + [P, P]
        rc = fn(v.data_ptr(), g.data_ptr(), out.data_ptr(), work.data_ptr(), 1, 1, 3, *size,
                *size, *f, mplan, stream())
        assert rc == 0, rc

    record = {"card": card, "shape": list(shape), "bound_ms": 36 * n_vox / 3.35e12 * 1e3}
    with tempfile.TemporaryDirectory() as tmp:
        record["shared_atomics"] = shared_atomics(tmp)
        print(f"shared-memory atomics (64-bit add, 32-bit add): {record['shared_atomics']}")
        libs = build_variants(root, tmp)
        built = libs["as_built"]
        record["whole"] = {"squaring_bwd": graph_ms(lambda: squaring.squaring_step_bwd(v, g)),
                           "warp_mgrad": graph_ms(lambda: warp.warp_mgrad(shape, v, g))}
        bwd(built["squaring_bwd"][0], 1)  # the header the march and convert read
        record["squaring_bwd_phases"] = {
            name: graph_ms(lambda ph=ph: bwd(built["squaring_bwd"][0], ph))
            for name, ph in (("memset_and_max", 1), ("march", 2), ("convert", 4))}
        bwd(built["squaring_bwd"][0], 7)
        torch.cuda.synchronize()
        assert torch.equal(out, squaring.squaring_step_bwd_plain(v, g))
        record["variants"] = {}
        for name, kernels in libs.items():
            bwd(kernels["squaring_bwd"][0], 1)
            r = {"squaring_bwd_march": graph_ms(lambda k=kernels: bwd(k["squaring_bwd"][0], 2)),
                 "warp_mgrad": graph_ms(lambda k=kernels: mgrad(k["warp_bwd"][0])),
                 "registers": {k: regs for k, (_, regs) in kernels.items()}}
            record["variants"][name] = r
            print(f"{name:11s} #2 march {r['squaring_bwd_march']:.5f} ms, #7 whole "
                  f"{r['warp_mgrad']:.5f} ms; registers {r['registers']}", flush=True)
    print(f"#2 whole {record['whole']['squaring_bwd']:.5f} ms, phases "
          + ", ".join(f"{k} {t:.5f}" for k, t in record["squaring_bwd_phases"].items())
          + f"; #7 whole {record['whole']['warp_mgrad']:.5f} ms; bound "
          f"{record['bound_ms']:.5f} ms (36 B a voxel over 3.35 TB/s)")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
