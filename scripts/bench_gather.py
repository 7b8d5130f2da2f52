#!/usr/bin/env python3
"""Time the gather kernels (csrc/warp.cu, csrc/squaring.cu) and the
training step's box sum, squaring backward, narrow conv and warp
df-cotangent, and the warp's moving-cotangent (csrc/box_sum.cu,
csrc/squaring_bwd.cu, csrc/conv_narrow.cu, csrc/warp_bwd.cu) at the
shapes the paths launch, at more than one tile plan, against another
checkout.

    python3 scripts/bench_gather.py [--parent DIR] [--json PATH] [--sass DIR]
                                    [--cases all|gather|training|seg]

For each case (a warp or a squaring step at a shape a path launches:
the full_res batched warp and its mean tail, the level_res decode's
warps at every level, LungCT's warp under its respiratory field, the 2D
warp; one squaring step at each flagship level, CL and CF, and the 2D
step; the box sum at each level's size and window of the flagship,
LungCT and flagship-2d steps; one squaring backward step at each
flagship and LungCT level, and at level 0 also under a sub-voxel field,
a 4-voxel one and the LungCT ramp; the moving-cotangent at C = 3 at the
flagship's and LungCT's level 0 (its place in the squaring backward) and
at C = 1 for the full-size image under 2 rows of a level-0 df; the bf16
narrow conv at the 5 shapes
a step launches of both configurations, 2 -> 32 at the input size and
3 -> 32 at each latent level; the df-cotangent (C = 1) at the 4 shapes a
step launches of both; the warp and the df-cotangent at C = 36, the
one-hot segmentation maps, at the 4 shapes of `transform_segmentation`
(chip_smoke.seg_shapes: the OASIS step's, the tables' and the figures'),
and the 2D warp at C = 36 over 10 rows of 160x192, the 2D OASIS
evaluation's; `--cases seg` runs these alone) it calls the C entry
points of:
- `v1`, `v4`: this checkout's libraries with the launch's plan at one
  and (the channels-first warp) four voxels a thread
  (kernels/gather.py); `new` is the one the wrappers take; the box sum,
  the squaring backward and the narrow conv at their plans (`new`) and,
  at levels 0 and 1 (the conv: at every shape), at plans for half and
  twice the target block count (`half`, `twice`; the conv: half and
  twice the planes a block marches); the df-cotangent at the forward
  warp's plan; at C = 36 the channel bodies instead (`quads`, 16-byte
  chunks, the one the wrappers take; `scalar`, one channel a thread, the
  body of a misaligned or C % 4 != 0 launch); for the df-cotangent
  `new` (one voxel a thread, 16-byte chunks of its channels) and
  `scalar` (the same call on copies of the map and cotangent 4 bytes
  past a 16-byte boundary: single channels);
- `parent`: with --parent, the same sources of the checkout at DIR,
  built with the same flags; an entry point of it that takes a plan
  (its source says so) gets the plan `new` takes, one that takes none
  is called without (and the narrow conv's with its float32 taps); at
  C = 36 also two probe copies of the parent's warp.cu, with its stores
  cut out (`no_stores`: an output is stored only if it equals a value no
  one-hot warp gives, so the gathers stay) and with its gathers cut out
  (`no_gathers`: a corner's value is its offset), whose outputs are
  wrong by construction and not compared.
Every output is held equal, bit for bit, to `v1`'s (`new`'s), and
`v1`'s to the plain version on the cases small enough to run it; the
squaring backward within 1e-5 of scale of the plain version on every
side, the moving-cotangent bit-equal to it (a parent that sums with
float32 atomics, in no fixed order: both within 1e-5 of scale), and a
second launch of each of the two scatters bit-equal to the first (they
sum order-free in fixed point, csrc/fixed.cuh); the narrow conv within one bf16 ulp
at the output's scale (the tensor cores sum in another order); the
df-cotangent bit-equal at C = 1, within 1e-5 of scale at C = 36 (the
channel sum's order differs by body). Times: CUDA events,
the median of 5 timings of `iters` calls, taken in turns (parent, v1,
v4, v4, v1, parent, without v4 where there is none); for the cases under 200 MB, whose calls are
host-bound, device times of a CUDA graph of the calls. With --sass DIR,
the SASS of this checkout's libraries goes to DIR and each
kernel's instruction mix is printed (HMMA: the tensor-core products),
with its atomic instructions in full (a native shared-memory float add,
or a compare-and-swap loop). The bound is each input read once and each
output written once over 3.35 TB/s. Prints the card, a table and each
path's device ms, and writes the records to --json. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12


# the parent checkout's C entry points that take a tile plan, those that
# take their body from the caller, and those that take a workspace (the
# fixed-point scatters' int64 targets)
PARENT_PLANS: set = set()
PARENT_BODIES: set = set()
PARENT_WORK: set = set()


def entries_with(root: str, param: str) -> set:
    """The C entry points of the checkout at `root` whose parameters
    include one named `param` (`plan`: a tile plan, `const int* plan`;
    `body`: the body their caller chose, `int body`), read from its
    sources."""
    out = set()
    csrc = os.path.join(root, "pulpo_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as fh:
                for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', fh.read()):
                    if re.search(rf"\b{param}\b", m.group(2)):
                        out.add(m.group(1))
    return out


def parent_plan(entry: str, plan):
    """The plan to give the parent's `entry`: `plan` if it takes one."""
    return plan if entry in PARENT_PLANS else None


def build_lib(src_path, tag: str, flags_of: str, include=None):
    """The library `tag` built from the source at `src_path` with the
    flags of this checkout's kernel `flags_of` (and `-I include`)."""
    from pulpo_tpu_torch.kernels import _build

    _, extra = _build.SOURCES[flags_of]
    lib = _build.BUILD_DIR / f"{tag}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), str(src_path), *_build.BASE_FLAGS, *extra,
           *([f"-I{include}"] if include else []), "-o", str(lib)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def build_parent(root: str, name: str):
    """The library of kernel `name` built from checkout `root`'s source
    with this checkout's flags."""
    from pulpo_tpu_torch.kernels import _build

    src, _ = _build.SOURCES[name]
    return build_lib(os.path.join(root, "pulpo_tpu_torch", "csrc", src), f"parent_lib{name}", name)


# the probe copies of the parent's warp.cu (its voxel body, which the
# C = 36 warps ran): text substitutions
PARENT_WARP_PROBES = {
    "no_stores": [("""      for (int ch = 0; ch < C; ++ch)
        __stcs(o + (CF ? ch * n_out + line + xq : (line + xq) * C + ch),
               interpolate<ND>(m + ch * cs_in, kk, mstride));""",
                   """      for (int ch = 0; ch < C; ++ch) {
        const float val = interpolate<ND>(m + ch * cs_in, kk, mstride);
        if (val == -1.25e-37f) __stcs(o + (CF ? ch * n_out + line + xq : (line + xq) * C + ch), val);
      }""")],
    "no_gathers": [("__ldg(mc + gather::corner_offset<ND>(k, corner, mstride))",
                    "(float)gather::corner_offset<ND>(k, corner, mstride)")],
}


def build_probes(root: str | None) -> dict:
    """The probe copies of the warp.cu of the parent checkout at `root`,
    by name (none without one)."""
    from pulpo_tpu_torch.kernels import _build

    out = {}
    if root is None:
        return out
    csrc = os.path.join(root, "pulpo_tpu_torch", "csrc")
    with open(os.path.join(csrc, "warp.cu")) as fh:
        src = fh.read()
    for name, subs in PARENT_WARP_PROBES.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"probe {name}: {old!r} is not in the parent's warp.cu")
            text = text.replace(old, new)
        path = _build.BUILD_DIR / f"probe_parent_warp_{name}.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out[name] = build_lib(path, f"probe_parent_warp_{name}", "warp", include=csrc)
    return out


def box_call(lib, x, out, win, plan=None, tmp=None):
    """One launch of `lib`'s box-sum entry on x (B, D, H, W) or (B, H, W)
    with `plan` (kernels/box_sum.py:box_sum_plan); plan None: an older
    entry, which takes a `tmp` buffer and no plan."""
    import torch

    from pulpo_tpu_torch.kernels import box_sum

    fn = getattr(lib, "pulpo_box_sum" if x.dim() == 4 else "pulpo_box_sum_2d")
    ptrs = [x.data_ptr(), out.data_ptr()] + ([] if plan is not None else [tmp.data_ptr()])
    tail = [box_sum.plan_arg(plan)] if plan is not None else []
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * (x.dim() + 1)
                   + [ctypes.c_void_p] * (len(tail) + 1))
    rc = fn(*ptrs, *x.shape, int(win), *tail, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"box_sum: CUDA error {rc}"


def bwd_call(lib, v, g, out, plan=None, work=None):
    """One launch of `lib`'s squaring backward on (v, g) with `plan`
    (kernels/gather.py:squaring_bwd_plan) and the int64 workspace `work`
    (the fixed-point scatter's, whose entry also takes its phases: all
    three); plan or work None: an entry without one."""
    import torch

    from pulpo_tpu_torch.kernels import gather, warp

    s = tuple(v.shape[1:4])
    fn = lib.pulpo_squaring_step_bwd
    ptrs = [v.data_ptr(), g.data_ptr(), out.data_ptr()] + ([] if work is None else
                                                           [work.data_ptr()])
    tail = [] if plan is None else [gather.plan_arg(plan)]
    phases = [] if work is None else [7]
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * len(tail) + [ctypes.c_int] * len(phases)
                   + [ctypes.c_void_p])
    rc = fn(*ptrs, v.shape[0], *s, *[warp._factor(x, x) for x in s], *tail, *phases,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"squaring_bwd: CUDA error {rc}"


def mgrad_call(lib, moving_shape, df, g, out, plan=None, work=None):
    """One launch of `lib`'s moving-cotangent of g by df into `out`
    (`moving_shape`) with `plan` (kernels/warp.py:mgrad_plan) and the
    int64 workspace `work`; plan or work None: an entry without one,
    which adds into `out` (zeroed here first, as its wrapper did)."""
    import torch

    from pulpo_tpu_torch.kernels import gather, warp

    b, c, s_in, s_out = warp._shapes(moving_shape, df.shape, False)
    fn = lib.pulpo_warp_mgrad
    if work is None:
        out.zero_()
    ptrs = [df.data_ptr(), g.data_ptr(), out.data_ptr()] + ([] if work is None else
                                                            [work.data_ptr()])
    tail = [] if plan is None else [gather.plan_arg(plan)]
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * (len(tail) + 1))
    rc = fn(*ptrs, b, df.shape[0], c, *s_in, *s_out,
            *[warp._factor(s_in[i], s_out[i]) for i in range(3)], *tail,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"warp_mgrad: CUDA error {rc}"


def conv_call(lib, x, weights, cout, out, plan=None):
    """One launch of `lib`'s narrow conv on a bf16 x with `plan`
    (kernels/conv_narrow.py:tile_plan) and the packed weights
    (`pack_weights`); plan None: an entry that runs bf16 on the CUDA
    cores, which takes the (27, cin, cout) float32 taps (`_taps`) and no
    plan. The weights are laid out before, outside the timed call."""
    import torch

    from pulpo_tpu_torch.kernels import conv_narrow

    fn = lib.pulpo_conv_narrow
    tail = [] if plan is None else [conv_narrow.plan_arg(plan)]
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * (len(tail) + 1))
    rc = fn(x.data_ptr(), weights.data_ptr(), out.data_ptr(), 1, x.shape[0], x.shape[4],
            *x.shape[1:4], cout, *tail, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"conv_narrow: CUDA error {rc}"


def dfgrad_call(lib, mov, df, g, out, plan=True, body=True):
    """One launch of `lib`'s df-cotangent on (mov, df, g) at the plan the
    wrapper takes (kernels/warp.py:dfgrad_plan), or at `plan` if it is a
    dict (kernels/gather.py); plan False: an entry that takes none. With
    `body` the body the wrapper chooses (kernels/warp.py:dfgrad_body) is
    passed; False: an entry that chooses its own."""
    import torch

    from pulpo_tpu_torch.kernels import gather, warp

    b, c, s_in, s_out = warp._shapes(mov.shape, df.shape, False)
    fn = lib.pulpo_warp_dfgrad
    if plan is True:
        plan = warp.dfgrad_plan(mov.shape, df.shape)
    tail = [gather.plan_arg(plan)] if plan else []
    chosen = [warp.dfgrad_body(mov, g)] if body else []
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * len(chosen) + [ctypes.c_void_p] * (len(tail) + 1))
    f = [warp._factor(s_in[i], s_out[i]) for i in range(3)]
    rc = fn(mov.data_ptr(), df.data_ptr(), g.data_ptr(), out.data_ptr(), b, df.shape[0], c,
            *s_in, *s_out, *f, *chosen, *tail, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"warp_dfgrad: CUDA error {rc}"


def warp_call(lib, mov, df, out, cf, v=None, ch=0):
    """One launch of `lib`'s warp entry on these tensors (the wrapper's
    arguments, kernels/warp.py:_launch) with the plan at `v` voxels a
    thread, or of the channel body of `ch` channels a chunk; v None: an
    entry that takes no plan."""
    import torch

    from pulpo_tpu_torch.kernels import gather, warp

    b, c, s_in, s_out = warp._shapes(mov.shape, df.shape, cf)
    nd = len(s_in)
    entry = "pulpo_warp_cf" if cf else ("pulpo_warp_2d" if nd == 2 else "pulpo_warp")
    fn = getattr(lib, entry)
    plan = []
    if v is not None:
        z, y, x = gather.axes(s_out)
        rows = df.shape[0] // b
        plan = [gather.plan_arg(gather.channel_plan(x, y, z, rows, b, c, ch) if ch
                                else gather.make_plan(x, y, z, rows, b, v))]
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (3 + 2 * nd)
                   + [ctypes.c_float] * nd + [ctypes.c_void_p] * (len(plan) + 1))
    f = [warp._factor(s_in[i], s_out[i]) for i in range(nd)]
    rc = fn(mov.data_ptr(), df.data_ptr(), out.data_ptr(), b, df.shape[0], c, *s_in, *s_out, *f,
            *plan, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"{entry}: CUDA error {rc}"


def step_call(lib, vec, out, cf, v=None, scale=1.0):
    """One launch of `lib`'s squaring entry (kernels/squaring.py:_launch_step)
    with its plan (one voxel a thread); v None: an entry without one."""
    import torch

    from pulpo_tpu_torch.kernels import gather, warp

    s = tuple(vec.shape[2:]) if cf else tuple(vec.shape[1:-1])
    nd = len(s)
    entry = "pulpo_squaring_step_cf" if cf else ("pulpo_squaring_step_2d" if nd == 2
                                                 else "pulpo_squaring_step")
    fn = getattr(lib, entry)
    plan = [] if v is None else [gather.plan_arg(gather.squaring_plan(s, vec.shape[0]))]
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * (nd + 1)
                   + [ctypes.c_float] * (nd + 1) + [ctypes.c_void_p] * (len(plan) + 1))
    rc = fn(vec.data_ptr(), out.data_ptr(), vec.shape[0], *s, *[warp._factor(x, x) for x in s],
            float(scale), *plan, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"{entry}: CUDA error {rc}"


# "/*0080*/  @!P0 BRA 0x120 ;": the opcode, past an address and a predicate
SASS_LINE = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
SASS_OPS = ("HMMA", "LDG", "STG", "LDS", "STS", "LDGSTS", "BAR", "IMAD", "IADD3", "LEA", "FMUL", "FADD",
            "FMNMX", "FRND", "F2I", "I2F", "ISETP", "BRA", "SHFL", "ATOMS", "ATOMG", "ATOM", "RED",
            "REDG")
# the opcode with its modifiers, for the atomics: "ATOMS.CAST.SPIN", "REDG.E.ADD.F32..."
SASS_ATOMIC = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?((?:ATOM|RED)[A-Z]*[.\w]*)")


def sass_summary(out_dir: str, kernels) -> None:
    """Dump the SASS of this checkout's libraries `kernels` into `out_dir`
    and print, per kernel, its instruction count, mix and atomics."""
    from pulpo_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for k in kernels:
        usage = subprocess.run([cuobjdump, "-res-usage", str(_build._target(k)[0])], check=True,
                               capture_output=True, text=True).stdout.splitlines()
        for name, res in zip(usage, usage[1:]):
            if name.strip().startswith("Function") and "REG" in res:
                print(f"  resources {k}: {name.strip()[9:79]} {res.strip()}")
        text = subprocess.run([cuobjdump, "-sass", str(_build._target(k)[0])], check=True,
                              capture_output=True, text=True).stdout
        with open(os.path.join(out_dir, f"{k}.sass"), "w") as fh:
            fh.write(text)
        for block in text.split("Function : ")[1:]:
            name = block.splitlines()[0].strip()
            ops = [m.group(1) for m in map(SASS_LINE.match, block.splitlines()) if m]
            mix = {o: sum(1 for x in ops if x == o) for o in SASS_OPS}
            atomics = sorted({m.group(1) for m in map(SASS_ATOMIC.match, block.splitlines())
                              if m})
            print(f"  sass {k}: {name[:70]} {len(ops)} instructions; "
                  + " ".join(f"{o} {c}" for o, c in mix.items() if c)
                  + (f"; atomics {' '.join(atomics)}" if atomics else ""))


FULL, LUNG = (160, 192, 224), (192, 192, 208)  # flagship's and LungCT's input sizes
LEVELS = [(80, 96, 112), (40, 48, 56), (20, 24, 28), (10, 12, 14)]  # flagship latent levels
LUNG_LEVELS = [(96, 96, 104), (48, 48, 52), (24, 24, 26), (12, 12, 13)]  # LungCT's
FULL_2D = FULL[:2]  # flagship-2d's input size and latent levels: the flagship's first two axes
LEVELS_2D = [s[:2] for s in LEVELS]
PATHS = ("level_res request", "full_res request", "flagship step", "LungCT step", "2D step",
         "OASIS step, C=36")
PATH_KEYS = dict(zip(("level_res_request", "full_res_request", "flagship_step", "LungCT_step",
                      "step_2d", "OASIS_step"), PATHS))
WINDOWS = (9, 7, 5, 3)  # the NCC window at latent levels 0-3 (config.window_size)


def cases(dev):
    """The cases, each a dict: name, kind ("warp": tensors (moving, df);
    "step": (field,)), cf, bytes (each input read once, each output
    written once), plain (small enough to check against the plain
    version), paths (launches of that call per warm UQ-32 request or
    training step, from the code). Per level, the integration runs at the
    level's size: in a request a decode integration of 32 rows and a
    mean-tail one of 1 row, in a B = 1 step one of 1 row, 7 steps each.
    The warps run at `df_size(l)`, which is the input size at level 0
    even at level_res (pulpo_tpu_torch/config.py:df_size): the level_res
    decode warps 32 rows of each level's image (level 0: the input), the
    mean tail the input image by each level's 1-row mean df, a training
    step each level's image by its 1-row df; the full_res request makes
    one batched CF warp of 4 x 32 rows and a 4-row tail. The 32-row warp
    at the latent level-0 size (80x96x112) is on no path."""
    import torch

    from chip_smoke import respiratory_field, smooth_field

    cf_of = lambda v: v.movedim(-1, 1).contiguous()
    full = FULL
    n = math.prod(full)
    img = torch.rand((1, *full, 1), device=dev)
    out = []

    def add(name, kind, tensors, cf, bytes_, plain, **paths):
        out.append(dict(name=name, kind=kind, tensors=tensors, cf=cf, bytes=bytes_, plain=plain,
                        paths={PATH_KEYS[p]: k for p, k in paths.items()}))

    for rows in (128, 4):
        df = cf_of(smooth_field(rows, full, 3.0, seed=300 + rows, device=dev))
        add(f"#8 warp_cf {rows} rows 160x192x224", "warp", (cf_of(img), df), True,
            4 * (rows * n * 4 + n), rows <= 4, full_res_request=1)
    df = smooth_field(32, full, 3.0, seed=302, device=dev)
    add("#4 warp 32 rows 160x192x224 (level 0, phase 6)", "warp", (img, df), False,
        4 * (32 * n * 4 + n), False, level_res_request=1)
    add("#4 warp 1 row 160x192x224 (level 0)", "warp",
        (img, smooth_field(1, full, 3.0, seed=301, device=dev)), False, 4 * n * 5, True,
        level_res_request=1, flagship_step=1)
    for l, size in enumerate(LEVELS):
        nl = math.prod(size)
        fmt = "x".join(map(str, size))
        on_path = {} if l == 0 else {"level_res_request": 1}
        m = torch.rand((1, *size, 1), device=dev)
        add(f"#4 warp 32 rows {fmt}", "warp", (m, smooth_field(32, size, 3.0, seed=303 + l,
                                                                device=dev)),
            False, 4 * (32 * nl * 4 + nl), l > 0, **on_path)
        if l > 0:
            add(f"#4 warp 1 row {fmt}", "warp", (m, smooth_field(1, size, 3.0, seed=313 + l,
                                                                  device=dev)),
                False, 4 * nl * 5, True, flagship_step=1)
            add(f"#4 warp 1 row 160x192x224 image, {fmt} df", "warp",
                (img, smooth_field(1, size, 3.0, seed=323 + l, device=dev)), False,
                4 * (nl * 4 + n), True, level_res_request=1)
        for rows in (32, 1):
            v = smooth_field(rows, size, 3.0, seed=330 + l + rows, device=dev)
            bytes_ = 2 * rows * nl * 3 * 4
            add(f"#1 squaring CL {rows} rows {fmt}", "step", (v,), False, bytes_, l > 1 or rows == 1,
                level_res_request=7, **({"flagship_step": 7} if rows == 1 else {}))
            add(f"#3 squaring CF {rows} rows {fmt}", "step", (cf_of(v),), True, bytes_,
                l > 1 or rows == 1, full_res_request=7)
    lung = LUNG
    nl = math.prod(lung)
    add("#5 warp 1 row 192x192x208 LungCT ramp (level 0)", "warp",
        (torch.rand((1, *lung, 1), device=dev), respiratory_field(lung, 16.0, 4.0, dev)),
        False, 4 * nl * 5, True, LungCT_step=1)
    for l, size in enumerate(LUNG_LEVELS):
        nl = math.prod(size)
        fmt = "x".join(map(str, size))
        if l > 0:
            add(f"#5 warp 1 row {fmt} LungCT ramp", "warp",
                (torch.rand((1, *size, 1), device=dev),
                 respiratory_field(size, 16.0 / 2**(l + 1), 4.0 / 2**(l + 1), dev)),
                False, 4 * nl * 5, True, LungCT_step=1)
        v = respiratory_field(size, 8.0 / 2**(l + 1), 2.0 / 2**(l + 1), dev) * (1.0 / 128)
        add(f"#1 squaring CL 1 row {fmt} LungCT ramp", "step", (v,), False, 2 * nl * 3 * 4,
            True, LungCT_step=7)
    m3 = smooth_field(1, LEVELS[0], 1.0, seed=309, device=dev)
    add("#4 warp C=3 32 rows 80x96x112 (field by field)", "warp",
        (m3, smooth_field(32, LEVELS[0], 3.0, seed=310, device=dev)), False,
        4 * math.prod(LEVELS[0]) * (32 * 6 + 3), False)
    d2 = FULL_2D
    add("2D warp 32 rows 160x192", "warp",
        (torch.rand((1, *d2, 1), device=dev), smooth_field(32, d2, 3.0, seed=311, device=dev,
                                                           channels=2)),
        False, 4 * math.prod(d2) * (32 * 3 + 1), True)
    for size in LEVELS_2D[:2]:  # flagship-2d's levels 0 and 1
        v = smooth_field(32, size, 3.0, seed=340 + size[0], device=dev, channels=2)
        add(f"2D squaring 32 rows {'x'.join(map(str, size))}", "step", (v,), False,
            2 * 32 * math.prod(size) * 2 * 4, True)
    return out


def seg_warps(dev):
    """(level, moving one-hot map, df) of each C = 36 warp of
    `transform_segmentation` (chip_smoke.seg_shapes: the OASIS step's,
    the tables' and the figures' 4 levels, a smooth 3-voxel df), and of
    the 2D OASIS evaluation (10 rows of 160x192, level "2d")."""
    from chip_smoke import FLAGSHIP_2D, OASIS, SEG_CLASSES, onehot_volume, seg_shapes, \
        smooth_field
    from pulpo_tpu_torch import PULPoConfig

    out = []
    for l, (mshape, dshape) in enumerate(seg_shapes(PULPoConfig(**OASIS))):
        out.append((l, onehot_volume(mshape, 500 + l, dev),
                    smooth_field(dshape[0], dshape[1:-1], 3.0, seed=510 + l, device=dev)))
    full = FLAGSHIP_2D["input_size"]
    out.append(("2d", onehot_volume((1, *full, SEG_CLASSES), 520, dev).repeat_interleave(10, 0),
                smooth_field(10, full, 3.0, seed=521, device=dev, channels=2)))
    return out


def seg_cases(dev):
    """The C = 36 warps of `seg_warps`, as `cases` gives its cases."""
    fmt = lambda s: "x".join(map(str, s))
    out = []
    for l, m, df in seg_warps(dev):
        n_in, n_out, nd = math.prod(m.shape[:-1]), math.prod(df.shape[:-1]), df.shape[-1]
        c = m.shape[-1]
        name = (f"#4 warp C={c} level {l} {fmt(m.shape[1:-1])}" if l != "2d" else
                f"2D warp C={c} 10 rows {fmt(m.shape[1:-1])}")
        out.append(dict(name=name, kind="warp", tensors=(m, df), cf=False,
                        bytes=4 * (n_in * c + n_out * (nd + c)), plain=l != 0,
                        paths={} if l == "2d" else {PATHS[-1]: 1}))
    return out


def seg_training_cases(dev):
    """The df-cotangent at C = 36 at the 3D shapes of `seg_warps`, a
    random cotangent, one launch each in an OASIS step."""
    import torch

    out = []
    for l, m, df in seg_warps(dev):
        if l == "2d":
            continue
        c = m.shape[-1]
        g = torch.randn((*df.shape[:-1], c), device=dev)
        n_in, n_out = math.prod(m.shape[:-1]), math.prod(df.shape[:-1])
        out.append(dict(name=f"#6 warp_dfgrad C={c} level {l} {'x'.join(map(str, m.shape[1:-1]))}",
                        kind="dfgrad", tensors=(m, df, g), cf=False,
                        bytes=4 * (n_in * c + n_out * (c + 6)), plain=l != 0, variants=False,
                        channels=True, paths={PATHS[-1]: 1}))
    return out


def training_cases(dev):
    """The box sum, squaring backward, narrow conv and df-cotangent
    cases, as `cases` gives the gathers': per level of the flagship and
    LungCT steps, the box sum
    at the level's NCC size (`df_size`: the input size at level 0) and
    window, 8 calls a step (5 forward, 3 backward), and one squaring
    backward at the level's size, 7 a step (one per integration step),
    its field a smooth one of max |v| = 1 voxel; at level 0 also under a
    0.4-voxel field, a 4-voxel one and the LungCT ramp's next-to-last
    step input; flagship-2d's box sums (2D step); the narrow conv at
    the 5 shapes and the df-cotangent at the 4 shapes a step launches
    (one call each)."""
    import torch

    from chip_smoke import DRIFT, SI_RAMP, narrow_weight, respiratory_field, smooth_field

    out = []

    def add(name, kind, tensors, bytes_, plain, variants, **paths):
        out.append(dict(name=name, kind=kind, tensors=tensors, cf=False, bytes=bytes_,
                        plain=plain, variants=variants,
                        paths={PATH_KEYS[p]: k for p, k in paths.items()}))

    for tag, full, levels, path in (("flagship", FULL, LEVELS, "flagship_step"),
                                    ("LungCT", LUNG, LUNG_LEVELS, "LungCT_step"),
                                    ("2D", FULL_2D, LEVELS_2D, "step_2d")):
        for l, win in enumerate(WINDOWS):
            size = full if l == 0 else levels[l]
            x = torch.rand((1, *size), device=dev)
            fmt = "x".join(map(str, size))
            add(f"#9 box_sum {tag} level {l} {fmt} win {win}", "box", (x, win),
                8 * math.prod(size), l > 0, l < 2 and tag != "2D", **{path: 8})
    for tag, levels, path in (("flagship", LEVELS, "flagship_step"),
                              ("LungCT", LUNG_LEVELS, "LungCT_step")):
        for l, size in enumerate(levels):
            fmt = "x".join(map(str, size))
            g = torch.randn((1, *size, 3), device=dev)
            v = smooth_field(1, size, 1.0, seed=350 + l, device=dev)
            add(f"#2 squaring_bwd {tag} level {l} {fmt} |v|<=1", "bwd", (v, g),
                36 * math.prod(size), True, l < 2, **{path: 7})
            if l == 0:
                for mag in (0.4, 4.0):
                    add(f"#2 squaring_bwd {tag} level 0 {fmt} |v|<={mag:g}", "bwd",
                        (smooth_field(1, size, mag, seed=360, device=dev), g),
                        36 * math.prod(size), True, False)
        if tag == "LungCT":
            v = respiratory_field(levels[0], SI_RAMP / 4, DRIFT / 4, dev)
            g = torch.randn((1, *levels[0], 3), device=dev)
            add(f"#2 squaring_bwd LungCT level 0 ramp {SI_RAMP / 4:g}", "bwd", (v, g),
                36 * math.prod(levels[0]), True, False)
    for tag, full, levels, path in (("flagship", FULL, LEVELS, "flagship_step"),
                                    ("LungCT", LUNG, LUNG_LEVELS, "LungCT_step")):
        # the narrow conv: down_block_0's 2 -> 32 at the input size, each
        # latent level's velocity head's 3 -> 32 (bf16, B = 1)
        for cin, size in ((2, full), *((3, s) for s in levels)):
            nv = math.prod(size)
            x = torch.randn((1, *size, cin), device=dev).to(torch.bfloat16)
            w = narrow_weight(cin, 32, 400 + cin + size[0], dev)
            add(f"#12 conv_narrow {tag} {cin}->32 {'x'.join(map(str, size))}", "conv", (x, w),
                2 * nv * (cin + 32), True, True, **{path: 1})
        # the moving-cotangent (#7, no path launches it): level 0 at C = 3
        # (its place in the squaring backward) under the path's field, and
        # the full-size image under 2 rows of a level-0 df (level_res)
        df = (smooth_field(1, levels[0], 3.0, seed=420, device=dev) if tag == "flagship"
              else respiratory_field(levels[0], SI_RAMP / 2, DRIFT / 2, dev))
        g = torch.randn((1, *levels[0], 3), device=dev)
        add(f"#7 warp_mgrad {tag} level 0 {'x'.join(map(str, levels[0]))} C=3", "mgrad",
            ((1, *levels[0], 3), df, g), 36 * math.prod(levels[0]), True, tag == "flagship")
        if tag == "flagship":
            df = smooth_field(2, levels[0], 3.0, seed=421, device=dev)
            g = torch.randn((2, *levels[0], 1), device=dev)
            add(f"#7 warp_mgrad flagship 2 rows {'x'.join(map(str, levels[0]))} df, "
                f"{'x'.join(map(str, full))} image", "mgrad", ((1, *full, 1), df, g),
                2 * math.prod(levels[0]) * 16 + 4 * math.prod(full), True, False)
        # the df-cotangent: each level's image by its df (level 0: the
        # input size), C = 1, under the path's field
        for l in range(4):
            size = full if l == 0 else levels[l]
            df = (smooth_field(1, size, 3.0, seed=410 + l, device=dev) if tag == "flagship"
                  else respiratory_field(size, SI_RAMP / 2**l, DRIFT / 2**l, dev))
            m = torch.rand((1, *size, 1), device=dev)
            g = torch.randn((1, *size, 1), device=dev)
            add(f"#6 warp_dfgrad {tag} level {l} {'x'.join(map(str, size))}", "dfgrad",
                (m, df, g), math.prod(size) * (4 + 12 + 4 + 12), True, False, **{path: 1})
    return out


def run_training_case(case: dict, libs: dict, dev) -> dict:
    """A box-sum, squaring-backward, narrow-conv, df-cotangent or
    moving-cotangent case: every side's output held to the plain version
    (bit-equal; 1e-5 of scale for the squaring backward and a
    float32-atomic parent's scatter, one bf16 ulp at scale for the conv)
    and to `new`'s, a scatter's second launch to its first, then timed in
    turns (parent, new, half, twice, twice, half, new, parent, each where
    there is one)."""
    import torch

    from chip_smoke import graph_ms, misaligned
    from pulpo_tpu_torch.kernels import box_sum, conv_narrow, gather, squaring, warp

    name, kind, tensors, bytes_ = (case[k] for k in ("name", "kind", "tensors", "bytes"))
    channels = case.get("channels", False)  # the C = 36 df-cotangent
    sides = ["new"] + (["half", "twice"] if case["variants"] else [])
    if channels:
        sides.append("scalar")
    if "parent" in libs:
        sides.append("parent")
    if kind == "box":
        x, win = tensors
        b, *rest = x.shape
        dims = rest if x.dim() == 4 else (1, *rest)
        target = box_sum.TARGET_BLOCKS
        plans = {}
        for side, t in (("new", target), ("half", target // 2), ("twice", target * 2)):
            box_sum.TARGET_BLOCKS = t
            plans[side] = box_sum.box_sum_plan(b, *dims)
        box_sum.TARGET_BLOCKS = target
        tmp = torch.empty_like(x)
        mk = lambda: torch.empty_like(x)
        entry = "pulpo_box_sum" if x.dim() == 4 else "pulpo_box_sum_2d"
        plans["parent"] = parent_plan(entry, plans["new"])
        call = lambda k, o: box_call(libs["parent" if k == "parent" else "new"]["box_sum"], x, o,
                                     win, plans[k], tmp)
        plain = lambda: box_sum.box_sum_plain(x, win)
    elif kind == "conv":
        x, w = tensors
        s0 = x.shape[1]
        plans = {"new": conv_narrow.tile_plan(*x.shape[:4], torch.cuda.get_device_properties(
            dev).multi_processor_count)}
        for side, tz in (("half", max(1, plans["new"]["tz"] // 2)),
                         ("twice", min(s0, 2 * plans["new"]["tz"]))):
            plans[side] = dict(plans["new"], tz=tz, chunks=-(-s0 // tz))
        mk = lambda: torch.empty((*x.shape[:4], w.shape[0]), device=dev, dtype=x.dtype)
        plans["parent"] = parent_plan("pulpo_conv_narrow", plans["new"])
        packed, taps = conv_narrow.pack_weights(w), conv_narrow._taps(w, torch.bfloat16)
        call = lambda k, o: conv_call(libs["parent" if k == "parent" else "new"]["conv_narrow"],
                                      x, taps if plans[k] is None else packed, w.shape[0], o,
                                      plans[k])
        plain = lambda: conv_narrow.conv_narrow_plain(x, w)
    elif kind == "dfgrad":
        m, df, g = tensors
        plans = {"new": warp.dfgrad_plan(m.shape, df.shape)}
        plans["scalar"] = plans["new"]
        plans["parent"] = plans["new"] if "pulpo_warp_dfgrad" in PARENT_PLANS else False
        mk = lambda: torch.empty_like(df)
        # the single-channel body: the same values 4 bytes past a 16-byte boundary
        args = {"scalar": (misaligned(m), df, misaligned(g))} if channels else {}
        call = lambda k, o: dfgrad_call(libs["parent" if k == "parent" else "new"]["warp_bwd"],
                                        *args.get(k, (m, df, g)), o, plans[k],
                                        k != "parent" or "pulpo_warp_dfgrad" in PARENT_BODIES)
        plain = lambda: warp.warp_dfgrad_plain(m, df, g)
    elif kind == "mgrad":
        shape, df, g = tensors
        target = gather.BWD_TARGET_BLOCKS
        plans = {}
        for side, t in (("new", target), ("half", target // 2), ("twice", target * 2)):
            gather.BWD_TARGET_BLOCKS = t
            plans[side] = warp.mgrad_plan(df.shape)
        gather.BWD_TARGET_BLOCKS = target
        plans["parent"] = parent_plan("pulpo_warp_mgrad", plans["new"])
        mk = lambda: torch.empty(shape, device=dev)
        work = torch.empty(math.prod(shape) + 1, device=dev, dtype=torch.int64)
        works = {k: None if k == "parent" and "pulpo_warp_mgrad" not in PARENT_WORK else work
                 for k in sides}
        call = lambda k, o: mgrad_call(libs["parent" if k == "parent" else "new"]["warp_bwd"],
                                       shape, df, g, o, plans[k], works[k])
        plain = lambda: warp.warp_mgrad_plain(shape, df, g)
    else:
        v, g = tensors
        target = gather.BWD_TARGET_BLOCKS
        plans = {}
        for side, t in (("new", target), ("half", target // 2), ("twice", target * 2)):
            gather.BWD_TARGET_BLOCKS = t
            plans[side] = gather.squaring_bwd_plan(v.shape[1:4], v.shape[0])
        gather.BWD_TARGET_BLOCKS = target
        mk = lambda: torch.empty_like(v)
        plans["parent"] = parent_plan("pulpo_squaring_step_bwd", plans["new"])
        work = torch.empty(v.numel() + 1, device=dev, dtype=torch.int64)
        works = {k: None if k == "parent" and "pulpo_squaring_step_bwd" not in PARENT_WORK
                 else work for k in sides}
        call = lambda k, o: bwd_call(libs["parent" if k == "parent" else "new"]["squaring_bwd"],
                                     v, g, o, plans[k], works[k])
        plain = lambda: squaring.squaring_step_bwd_plain(v, g)
    outs = {}
    for k in sides:
        outs[k] = mk()
        call(k, outs[k])
    torch.cuda.synchronize()
    with torch.no_grad():
        ref = (plain() if case["plain"] else outs["new"]).float()
    scale = max(1.0, float(ref.abs().max()))
    err = {k: float((outs[k].float() - ref).abs().max()) for k in sides}
    tol = {"box": 0.0, "dfgrad": 1e-5 * scale if channels else 0.0, "bwd": 1e-5 * scale,
           "mgrad": 0.0, "conv": 2.0 ** (math.floor(math.log2(scale)) - 7)}[kind]
    # a float32-atomic parent sums in no fixed order: 1e-5 of scale
    loose = {k: 1e-5 * scale for k in sides
             if k == "parent" and kind in ("mgrad", "bwd") and k in works and works[k] is None}
    same = {k: err[k] <= loose.get(k, tol) for k in sides}
    if kind in ("mgrad", "bwd"):  # order-free: a second launch, the same bits
        again = mk()
        call("new", again)
        same["new_again"] = torch.equal(again, outs["new"])
    order = [k for k in ("parent", "new", "half", "twice", "scalar") if k in sides]
    order += order[::-1]
    times = {}
    for k in order:
        o = outs[k]
        times.setdefault(k, []).append(graph_ms(lambda k=k, o=o: call(k, o)))
    bound = bytes_ / HBM_BYTES_PER_S * 1e3
    best = statistics.median(times["new"])
    record = {"case": name, "bound_ms": bound, "equal": same, "max_abs_err": err,
              "device_graph": True, "paths": case["paths"], "ms": times,
              "plans": {k: plans[k] for k in plans if k in sides and plans[k]}}
    line = f"{name:48s} bound {bound:8.4f}  new {best:.4f} ({bound / best:.2f} of bound)"
    for k in [k for k in sides if k != "new"]:
        if k in times:
            line += f"  {k} {' / '.join(f'{t:.4f}' for t in times[k])}"
    print(line + f"  err {' '.join(f'{k} {e:.1e}' for k, e in err.items())}  equal {same}",
          flush=True)
    del outs
    torch.cuda.empty_cache()
    return record


def run_case(case: dict, libs: dict, dev) -> dict:
    """Run one case on this checkout's plans or bodies and on the parent:
    outputs held equal to the wrappers' choice's (`new`; it to the plain
    version's where small), then timed in turns. Prints a line; returns
    the record. The probe copies' outputs are not compared."""
    import torch

    from chip_smoke import graph_ms, time_ms
    from pulpo_tpu_torch.kernels import squaring, warp

    name, kind, tensors, cf, bytes_ = (case[k] for k in ("name", "kind", "tensors", "cf",
                                                          "bytes"))
    # side: (library set, library, voxels a thread, channels a chunk)
    sides = {"v1": ("new", "warp", 1, 0)}
    if kind == "warp" and cf:
        sides["v4"] = ("new", "warp", 4, 0)
    probes = []
    if kind == "warp":
        mov, df = tensors
        _, c, s_in, s_out = warp._shapes(mov.shape, df.shape, cf)
        shape = (df.shape[0], c, *s_out) if cf else (df.shape[0], *s_out, c)
        mk = lambda: torch.empty(shape, device=dev)
        call = lambda k, o: warp_call(libs[sides[k][0]][sides[k][1]], mov, df, o, cf,
                                      sides[k][2], sides[k][3])
        plain = (lambda: warp.warp_cf_plain(mov, df)) if cf else (lambda: warp.warp_plain(mov, df))
        plan = warp.tile_plan(mov.shape, df.shape, cf)
        if plan["ch"]:
            sides = {"quads": ("new", "warp", 1, 4), "scalar": ("new", "warp", 1, 1)}
            if "parent" in libs:
                probes = [k for k in PARENT_WARP_PROBES if k in libs["probes"]]
        chosen = {4: "quads", 1: "scalar"}.get(plan["ch"], f"v{plan['v']}")
        entry = "pulpo_warp_cf" if cf else ("pulpo_warp_2d" if len(s_in) == 2 else "pulpo_warp")
        chosen_v = plan["v"]
    else:
        (vec,) = tensors
        mk = lambda: torch.empty_like(vec)
        call = lambda k, o: step_call(libs[sides[k][0]]["squaring"], vec, o, cf, sides[k][2])
        plain = ((lambda: squaring.squaring_step_cf_plain(vec)) if cf
                 else (lambda: squaring.squaring_step_plain(vec)))
        chosen_v = squaring.tile_plan(vec.shape, cf)["v"]
        chosen = f"v{chosen_v}"
        nd = vec.dim() - 2
        entry = ("pulpo_squaring_step_cf" if cf else
                 ("pulpo_squaring_step_2d" if nd == 2 else "pulpo_squaring_step"))
    if "parent" in libs:
        sides["parent"] = ("parent", "warp", parent_plan(entry, chosen_v), 0)
    for k in probes:
        sides[k] = ("probes", k, 1, 0)
    outs = {}
    for k in sides:
        outs[k] = mk()
        call(k, outs[k])
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(outs[k], outs[chosen])) for k in sides if k not in probes}
    if case["plain"]:
        same["plain"] = bool(torch.equal(outs[chosen], plain()))
    # device times of a graph where a call's host side would outlast its kernel
    on_graph = bytes_ < 2e8
    timer = graph_ms if on_graph else (lambda fn: time_ms(fn, 5 if bytes_ > 4e9 else 20))
    order = [k for k in ("v1", "v4", "quads", "scalar", *probes) if k in sides]
    order += order[::-1]
    if "parent" in sides:
        order = ["parent", *order, "parent"]
    times = {}
    for k in order:
        o = outs[k]
        times.setdefault(k, []).append(timer(lambda k=k, o=o: call(k, o)))
    times["new"] = times[chosen]
    bound = bytes_ / HBM_BYTES_PER_S * 1e3
    record = {"case": name, "bound_ms": bound, "equal": same, "device_graph": on_graph,
              "paths": case["paths"], "v": chosen_v, "chosen": chosen, "ms": times}
    best = statistics.median(times["new"])
    line = f"{name:48s} bound {bound:8.4f}  new ({chosen}) {best:.4f} ({bound / best:.2f} of bound)"
    for k in [k for k in times if k != "new"]:
        line += f"  {k} {' / '.join(f'{t:.4f}' for t in times[k])}"
    print(line + f"  equal {same}", flush=True)
    del outs, tensors
    torch.cuda.empty_cache()
    return record


def path_sums(records: list, side: str) -> None:
    """Print each path's device ms of the kernels #1, #3, #4, #5, #8, #9,
    #2, #12, #6 on library `side`: launches x per-call time (the median), summed
    over the shapes the path launches, beside the bound."""
    for path in PATHS:
        for prefix in ("#1", "#3", "#4", "#5", "#8", "#9", "#2", "#12", "#6"):
            picked = [r for r in records if r["case"].split()[0] == prefix and path in r["paths"]
                      and side in r["ms"]]
            if picked:
                ms = sum(r["paths"][path] * statistics.median(r["ms"][side]) for r in picked)
                bound = sum(r["paths"][path] * r["bound_ms"] for r in picked)
                launches = sum(r["paths"][path] for r in picked)
                print(f"path {side:6s} {path:18s} {prefix}: {launches:3d} launches "
                      f"{ms:8.4f} ms, bound {bound:8.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout to time beside this one")
    ap.add_argument("--json", default=None)
    ap.add_argument("--sass", default=None, help="write the kernels' SASS under this directory "
                    "and print each kernel's instruction mix")
    ap.add_argument("--cases", default="all", choices=("all", "gather", "training", "seg"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import card_line
    from pulpo_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    training = ("box_sum", "squaring_bwd", "conv_narrow", "warp_bwd")
    names = {"gather": ("warp", "squaring"), "training": training, "seg": ("warp", "warp_bwd"),
             "all": ("warp", "squaring", *training)}[args.cases]
    _build.build_all(names)
    libs = {"new": {k: _build.load(k) for k in names}}
    for k in names:
        for line in _build.BUILD_LOGS.get(k, "").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                print(f"  ptxas {k}: {line.strip()}")
    if args.sass:
        sass_summary(args.sass, names)
    if args.parent:
        libs["parent"] = {k: build_parent(args.parent, k) for k in names}
        PARENT_PLANS.update(entries_with(args.parent, "plan"))
        PARENT_BODIES.update(entries_with(args.parent, "body"))
        PARENT_WORK.update(entries_with(args.parent, "work"))
    libs["probes"] = build_probes(args.parent if "warp" in names else None)

    records = []
    if args.cases in ("all", "gather"):
        records += [run_case(case, libs, dev) for case in cases(dev)]
    if args.cases in ("all", "gather", "seg"):
        records += [run_case(case, libs, dev) for case in seg_cases(dev)]
    if args.cases in ("all", "training"):
        records += [run_training_case(case, libs, dev) for case in training_cases(dev)]
    if args.cases in ("all", "training", "seg"):
        records += [run_training_case(case, libs, dev) for case in seg_training_cases(dev)]
    for side in [k for k in ("new", "parent") if k in libs]:
        path_sums(records, side)
    bad = [r["case"] for r in records if not all(r["equal"].values())]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "records": records}, fh, indent=1)
    print(f"card: {card}")
    if bad:
        print(f"bench_gather: outputs differ in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
