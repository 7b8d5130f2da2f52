#!/usr/bin/env python3
"""What bounds the narrow conv's tensor-core body (csrc/conv_narrow.cu)?

    python3 scripts/probe_conv_narrow_tc.py [--json PATH]

Builds this checkout's conv_narrow.cu as is and as probe variants, each
a copy with one part of the bf16 body cut out by a text substitution
(the copies go to the build directory, nothing in csrc/ changes):
- `no_a_loads`: the A fragments come from registers, not shared memory;
- `no_output`: no staged row is read back nor stored;
- `no_products`: no mma is issued (the accumulators stay 0).
A probe's output is wrong by construction; the body as is is held
within one bf16 ulp at scale of the plain version. Then it times it at
every z-chunk length (`tz`) at the shapes a flagship and a LungCT step
launch, and marks the chunk length `tile_plan` picks. Times: device
times of a CUDA graph of 20 launches (chip_smoke.graph_ms), the weights
packed beforehand. Prints the card and one line a shape. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
VARIANTS = {
    "no_a_loads": [("const uint32_t a[4] = {val(0, 0), val(1, 0), val(0, 1), val(1, 1)};",
                    "const uint32_t a[4] = {o, o ^ 1u, (uint32_t)xb[0], (uint32_t)xb[1]};")],
    "no_output": [("for (int q = lane; q < 64; q += 32) {",
                   "for (int q = lane; q < 64 && cout < 0; q += 32) {")],
    "no_products": [("if (j < nt) tc::mma_bf16(", "if (j < nt && cout < 0) tc::mma_bf16(")],
}
SHAPES = [(2, (160, 192, 224)), (3, (80, 96, 112)), (3, (40, 48, 56)), (3, (20, 24, 28)),
          (3, (10, 12, 14)), (2, (192, 192, 208)), (3, (96, 96, 104)), (3, (48, 48, 52)),
          (3, (24, 24, 26)), (3, (12, 12, 13))]
TZS = (1, 2, 4, 8, 12, 16, 23, 32, 46)


def build(variants: dict) -> dict:
    """One library a variant (`current`: the source as is), all nvcc runs
    started together; prints each bf16 body's registers and spills."""
    from pulpo_tpu_torch.kernels import _build

    src_path = _build.CSRC / "conv_narrow.cu"
    src = src_path.read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in {"current": [], **variants}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"probe {name}: {old!r} is not in conv_narrow.cu")
            text = text.replace(old, new)
        path = _build.BUILD_DIR / f"probe_conv_narrow_{name}.cu"
        path.write_text(text)
        lib = _build.BUILD_DIR / f"libprobe_conv_narrow_{name}.so"
        cmd = [_build._nvcc(), str(path), *_build.BASE_FLAGS, *_build.SOURCES["conv_narrow"][1],
               "-I", str(_build.CSRC), "-o", str(lib)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "conv_narrow_tcILi" in line and i + 3 < len(lines):
                inst = line.split("conv_narrow_tcILi")[1][:1]
                one = "one pass" if "ELb1E" in line else "passes"
                print(f"  ptxas {name} cin {inst} {one}: {lines[i + 3].strip()[14:80]}; "
                      f"{lines[i + 2].strip()[:60]}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_conv_narrow_tc: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import card_line, graph_ms, narrow_weight
    from pulpo_tpu_torch.kernels import conv_narrow

    card = card_line()
    print(f"card: {card}", flush=True)
    libs = build(VARIANTS)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    for cin, size in SHAPES:
        x = torch.randn((1, *size, cin), device=dev).to(torch.bfloat16)
        w = narrow_weight(cin, 32, 7, dev)
        packed = conv_narrow.pack_weights(w)
        with torch.no_grad():
            ref = conv_narrow.conv_narrow_plain(x, w).float()
        scale = max(1.0, float(ref.abs().max()))
        tol = 2.0 ** (math.floor(math.log2(scale)) - 7)
        plan = conv_narrow.tile_plan(1, *size, sms)
        bound = 2 * math.prod(size) * (cin + 32) / HBM_BYTES_PER_S * 1e3
        out = torch.empty((1, *size, 32), device=dev, dtype=torch.bfloat16)

        def timed(lib, tz):
            fn = lib.pulpo_conv_narrow
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
            arg = conv_narrow.plan_arg(dict(plan, tz=tz, chunks=-(-size[0] // tz)))
            call = lambda: fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(), 1, 1, cin, *size,
                              32, arg, torch.cuda.current_stream().cuda_stream)
            assert call() == 0
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            return graph_ms(call), err <= tol

        rec = {"cin": cin, "size": size, "bound_ms": bound, "plan_tz": plan["tz"], "ms": {}}
        line = f"{cin}->32 {'x'.join(map(str, size))} bound {bound:.4f} plan tz {plan['tz']}:"
        for tz in sorted({t for t in TZS if t <= size[0]} | {plan["tz"]}):
            ms, ok = timed(libs["current"], tz)
            rec["ms"][f"current/{tz}"] = ms
            line += f" {tz}{'*' if tz == plan['tz'] else ''}:{ms:.4f}{'' if ok else ' WRONG'}"
        for name in VARIANTS:
            ms, _ = timed(libs[name], plan["tz"])
            rec["ms"][name] = ms
            line += f" | {name} {ms:.4f}"
        print(line, flush=True)
        records.append(rec)
    print(f"card: {card}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "records": records}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
