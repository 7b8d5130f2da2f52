#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PULPo on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi); no CUDA device -> fail;
2. build the CUDA kernels from pulpo_tpu_torch/csrc (one nvcc per
   source, all started together);
3. hold each kernel against its plain PyTorch version (TF32 off) at the
   main paths' shapes, within a stated tolerance (the velocity head at
   level 0 on 2 rows, and in bf16 on 32 rows: the persistent grid at the
   size phase 6 times); the warp and squaring step also from a base 4
   bytes past a 16-byte boundary (their scalar path, bit-equal);
3c. the same under LungCT's large displacements: a respiratory field
   (a superior-inferior ramp to 16 voxels and an in-plane drift to 4)
   at 192x192x208 for the warp and its df-cotangent (bit-equal), at the
   level-0 size 96x96x104 for the moving-cotangent and the squaring
   backward (1e-5 of scale, float32 atomics), a squaring integration
   whose last step moves ~8 voxels (bit-equal), and the box sum at each
   LungCT level's size and window and the velocity head at its level 0
   (the tolerances of phase 3);
3d. the eval conv chains on the conv-unit kernel against their plain
   versions in bfloat16 and float32: the posterior head at each
   non-coarsest latent level of the flagship and of LungCT (4 rows over
   1 pair, so the y2 row broadcast runs; one permuted-memory input),
   the narrow-input chain on down_block_0 at both full sizes, random
   weights with non-trivial BatchNorm statistics; and the gradient
   through each eval kernel (velocity head, posterior head, conv chain)
   against its plain version's;
3e. the channels-first kernels against their channels-last twins bit
   for bit and against their plain versions: the CF integration on 32
   rows at 80x96x112 and under LungCT's respiratory field at 96x96x104,
   the CF image warp on 4 x 32 rows at 160x192x224 and a C = 3 CF warp;
   the narrow conv (bf16, f32) at 2 -> 32 on both full sizes and 3 -> 32
   on both level-0 sizes, and its gradient against the plain version's
   autograd; each case again with a non-contiguous input;
3f. the 2D kernels bit for bit against their plain versions at the
   `flagship-2d` path's shapes (the flagship network on a 160x192
   slice): the 2D squaring step on 32 rows at each level size, sub-voxel
   and under the LungCT ramp scaled to the slice, a 7-step integration
   and a permuted-memory input; the 2D warp of the 160x192 image by 32
   dfs at the full size and at each level's size, a border clamp, a
   permuted df and a C = 2 field warp; the 2D box sum at each level's
   NCC size and window;
3g. the segmentation shapes: the warp and its df-cotangent at the 36
   one-hot channels of the OASIS maps, at each level's shape of the
   flagship's `transform_segmentation` (the 160x192x224 map under the
   level-0 df, the pooled maps at 40x48x56, 20x24x28 and 10x12x14), the
   warp bit for bit and the df-cotangent within 1e-5 of scale; the 2D
   warp at C = 36 over 10 rows of 160x192, bit for bit;
4. a small-input reference: a UQ request on the card against the same
   weights and draws on the CPU (plain versions), leaf by leaf, at
   level_res and at full_res (the channels-first path);
4b. a small training step on the card against the same weights, batch
   and draws on the CPU: losses, gradients and BatchNorm statistics;
4c. phases 4 and 4b on a small 2D input (32x40);
5. the serving path: the flagship config (160x192x224, 5/4 levels,
   n0=32, bf16, level_res) with seeded random weights answers 3
   requests, each `predict_with_uncertainty` with N=32 on one synthetic
   pair. Every leaf must be finite and each kernel's launch count must
   equal the count the shapes give;
5c. the serve entry: the flagship model (random weights from seed 0)
   exported to a `.pulpo` artifact and loaded by `ServedModel` answers
   `predict_deterministic` once, `predict_mean` at N = 32 once and `uq`
   at N = 32 three times; the served outputs equal the live model's on
   the same inputs, seed, N and chunk bit for bit (the forward kernels
   use no atomics), with the launch counts the shapes give;
5d. the full-resolution request: the flagship network at
   df_resolution="full_res" with the default feedback less
   "transformed" (`flagship-fullres`) answers 3 UQ-32 requests on the
   channels-first field path: every leaf finite, the CF kernels' launch
   counts as the shapes give (per decode 4 levels x 7 squaring steps
   and one batched warp; per request the mean tail's the same), the
   request times and peaks logged;
5b. the training path: the same flagship config (NCC + KL + L2, Adam lr
   1e-4, B = 1) takes 1 warm-up and 5 timed `make_train_step` steps on a
   synthetic pair: finite losses, no NaN flag, changed weights, and the
   launch counts the shapes give (5 narrow convs a step);
5e. the 2D serving path: `flagship-2d` (160x192, 5/4 levels, n0=32,
   bf16, level_res) answers 3 UQ-32 requests: every leaf finite, exact
   launch counts of the 2D squaring and warp, 0 of every 3D kernel;
5f. the 2D training path: `flagship-2d` takes 1 + 5 steps as in 5b,
   with exact counts of the 2D box sum (32 a step), squaring and warp;
6. per-kernel times (CUDA events, the median of 5 repeats) beside their
   bounds, the plain versions' times and one library call's time (and,
   for the velocity head, the posterior head and the conv chain, their
   TFLOP/s and share of the bound); the
   warp also at the LungCT shape under the respiratory field; the
   posterior head at each flagship level at R = chunk (and held against
   its plain version there, bf16 within BF16_CHAIN_REL of scale, so that
   its persistent grid is checked at the size it is timed at) and the
   conv chain at full resolution, against the port's unfused eval chain
   (cuDNN convs with PyTorch epilogues) as the library yardstick; the CF
   kernels at the full-res request's shapes beside their channels-last
   twins (and `F.grid_sample` for the warp; the CF warp also on the
   request's 4-row mean tail), the narrow conv at the
   training step's shapes beside cuDNN's `F.conv3d`; the squaring
   backward beside the `grid_sample` VJP of one library step
   (v + grid_sample(v, identity + v)); the 2D kernels at
   the `flagship-2d` paths' shapes beside `F.grid_sample` and
   `F.avg_pool2d`; the warp and its df-cotangent at C = 36 at phase
   3g's shapes beside `F.grid_sample` and its VJP;
7. the LungCT path: the full-width LungCT config (192x192x208, 5/4
   levels, n0=32, bf16) trains for 4 steps through the port's `Trainer`
   (B = 1, validation, the two best checkpoints, `latest` and metrics
   after every step) on an in-memory dataset with `LungCT.get_pair`'s
   schema, served by the port's `DataLoader`; `Evaluate` reloads the run
   directory and writes the performance table and the N = 10
   uncertainty table with the landmark columns. The reloaded state must
   equal the saved one bit for bit, every loss and table entry must be
   finite (but where the zero-scrub gives NaN), and the launch counts
   must equal what the shapes give;
7b. `train_cli --ndims 2 --dataset synthetic` (its 64x64 default) for 2
   steps on the card in a temporary run directory: finite validation
   losses, exact launch counts, and a `latest` checkpoint that reloads
   bit for bit;
7c. `train_cli --ndims 2 --dataset oasis --segs --lms --recon_loss ncc
   dice` on an in-memory 2D OASIS store (160x192, 36 classes): 2 steps,
   then the tables it writes (Dice, the landmark columns, N = 10), every
   entry finite but the reference's NaNs, exact launch counts; and the
   `flagship-2d` model exported and served (its three entries, bit for
   bit against the live model);
8. the OASIS path: the flagship with segmentations (`OASIS`: NCC +
   Dice at dice_factor 50, 36 one-hot classes) at 160x192x224, the
   port's OASIS reader on an in-memory store (splits 4 / 2 / 2 / 2,
   landmarks on test_lm) feeding 4 Trainer steps (B = 1) with
   validation and checkpoints, then `Evaluate.run_one_model(task=
   "oasis")`: the performance table (Dice, landmarks) and the N = 10
   uncertainty table; finite entries, exact launch counts, a checkpoint
   that reloads bit for bit; the Trainer iteration with and without
   segmentations and the reader's own time a batch (the loader's share);
8b. remat: the OASIS segmentation step at B = 2 plain, under
   `remat_down=(0,)` and under `remat`, each twice: the loss and the
   BatchNorm statistics equal, the gradients no further from the plain
   step's (relative L2) than its own second run is (twice that, or
   1e-5; the float atomics of the squaring backward), exact launch counts (a
   checkpointed region's kernels launch again in the backward), the
   remat peaks below the plain one;
8c. BraTS: `train_cli` with its defaults (`--dataset brats`, float32)
   on an in-memory store at 144x192x160, 2 steps with validation: finite
   losses, exact launch counts, a checkpoint that reloads bit for bit.
9. the figure path: `evaluate_cli --task oasis --segs --lms --N 10`
   without `--no_visualize` (`Evaluate.run_one_model(visualize=True)`)
   on phase 8's run and store: per
   loader three predictions (deterministic, one sample, the mean over
   10), each figure's panels as `vis/*.npz` (the row count of the
   default menu, every image finite; a `.png` only where matplotlib
   imports, which the card's machine does not) and its JDet table, then
   the tables; exact launch counts, the time beside phase 8's
   `run_one_model(visualize=False)`, and the device time of the C = 36
   one-hot warps it launched (each shape timed);
9b. the same on phase 7c's 2D OASIS run (the 2D warp at C = 36 over
   the 10 samples' rows);
9c. the validation panels of phase 8's Trainer (`image_logging_frequency
   = 1`): one `images/step_<s>.npz` a validation, keyed by the JAX
   writer's tags, every grid uint8 (H, W, 3);
9d. the DIF-VoxelMorph baseline (`models/voxelmorph.py`): first card
   against CPU at 24x28x32 (the forward and an N = 4 `predict` with
   injected draws, 1e-5 of scale), then at 160x192x224 with weights from
   seed 0 on phase 8's store: `performance_vxm(1)`, `uncertainty_vxm(10)`
   and `performance_vxm(artifact="blur")` (which must differ from the
   clean table), 3 VoxelMorph-diff steps with a finite loss, exact
   launch counts of the narrow conv (its 2 -> 16 f32 first conv), the
   squaring step and the warp, and in training the squaring backward
   and the df-cotangent; a pair's times (CUDA events), the peaks, and
   each kernel's device time at the paths' shapes beside `F.conv3d` and
   `F.grid_sample`;
9e. `Evaluate.compare_models` over phase 8's run and a second run of
   the same config with weights from seed 1, at N = 2 (reduced from 10):
   one row a model, no NaN where a metric applies, exact launch counts;
10. the native loader: phase 8's store (training and validation splits,
   int16 labels, 36 classes) converted to volume stores
   (`native.convert_h5_to_store`), served by the C++ loader (built with
   g++ from `pulpo_tpu_torch/native/dataloader.cc`) through
   `DataLoader(NativeDataset(...))` to 4 OASIS Trainer steps (B = 1, NCC
   + Dice) without validation: the first batch equal to
   `convert_to_onehot` of its labels bit for bit, exact launch counts
   (#4 and #6 at C = 36 counted apart), read + one-hot seconds a batch
   and the loader's share of the iteration beside phase 8's h5py reader;
10b. ingest on the card: a raw B = 2 batch at BraTS's 240x240x155 from
   seed 0 through `data/ingest.ingest(target=(144, 192, 160),
   normalize="znorm")`, within 1e-5 of scale of the CPU result; its ms
   (CUDA events) and peak memory;
10c. the data-parallel step over NCCL at world size 1, the flagship at
   full width: `make_dp_train_step` against `make_train_step` on the
   same weights, batch and draws: losses and BatchNorm statistics equal
   bit for bit, gradients within the plain step's own run-to-run spread
   (#2's float32 atomics), exact launch counts, the step time beside
   phase 5b's;
10d. `train_cli --data_parallel 2 --dist_backend gloo` as two torchrun
   processes on the one card (a BraTS store at 64x64x64, 3 levels, 2
   steps, one validation): finite losses, the ranks' states equal bit
   for bit, rank 0 alone writing the run, `latest` reloading bit for
   bit, exact launch counts on each rank. A failed native build or NCCL
   start fails the run; nothing falls back;
11. the slab launches of the depth-sharded model (parallel/spatial.py)
   at the flagship's shapes split 2 ways: the warp (#4) and its
   df-cotangent (#6) at C = 1 of the level-0 df and of each split latent
   level's, and at C = 36 over the segmentation step's one-hot maps
   (160x192x224, 40x48x56, 20x24x28), the squaring step (#1) at each
   split latent level, and the full_res decode's channels-first slabs:
   the CF squaring step (#3) on a B = 1 field at each split latent level
   (80x96x112 in slabs of 40, 40x48x56 of 20, 20x24x28 of 10), with and
   without the first step's scale, and the CF image warp (#8) of the
   image by the 4-row stacked dfs of a B = 1 forward (160x192x224 in
   slabs of 80); each slab bit-equal to the matching planes of the
   whole launch and to the plain version at its offset; the step
   backward's (#2) slab shares within 1e-5 of scale of the whole
   backward of their cotangents; each slab's device time beside the
   whole launch's, and the body each C = 36 and #8 slab launch took;
11a-11f. two torchrun processes sharing the card over gloo (NCCL
   refuses two ranks on one device), the flagship at full width (B = 1):
   11a `make_spatial_forward` at mesh (data 1, space 2), in bf16 and in
   f32, each rank's slab of the level-0 final df and warped image
   against the unsharded forward's planes; 11b the step's gradients and
   losses at that mesh (`spatial_compute_grads`) against the unsharded
   step's (losses within 1e-5 relative, gradients within twice the
   unsharded step's own run-to-run or one-ulp distance, relative L2);
   11d the same for the OASIS segmentation (Dice) step in bf16 at B = 2
   and in f32 at B = 1 and for the flagship step with the jdet
   regularizer in f32 at B = 1, with each rank's peak beside the
   unsharded step's; 11e the bf16 B = 2 Dice step under `remat=True` and
   under `remat_down=(0,)`, against 11d's sharded step (losses equal,
   gradients within twice its run-to-run distance, relative L2), each
   rank's peak beside phase 8b's unsharded remat peaks and 11d's, the
   recomputed share of the exchanged bytes; 11f the flagship at full_res
   (the channels-first decode through slab launches of #3 and #8): the
   forward in f32 (held as 11a's f32) and bf16 (logged beside its own
   one-ulp distance), and the f32 B = 1 full_res step against the
   unsharded one (as 11d's f32 steps); 11c the output-channel split at
   model 2 (parallel/tp.py) against the replicated
   `predict_deterministic`.
   Exact launch counts on each rank; each rank's time, peak memory and
   exchanges (halo, all-gather, all-reduce bytes) beside the unsharded
   run's. The two ranks share one card, so their times are no
   multi-card figures.
11g. the 2D configuration under depth sharding (each image (B, H, W, C)
   sharded along H): first its slab launches at `flagship-2d`'s shapes
   split 2 ways, the 2D squaring step (#1's 2D arm) on 2 rows at
   160x192, 80x96, 40x48 and 20x24 (slabs of 80, 40, 20, 10 lines), with
   and without the first step's scale, the 2D warp at C = 1 of the
   level-0 df and of each split latent level's, and at C = 36 over the
   2D Dice step's one-hot maps (2 rows; 160x192, 40x48, 20x24): each
   slab bit-equal to the matching lines of the whole launch and to the
   plain version at its offset, its device time beside the whole
   launch's, the body each 2D warp slab took; then, as two torchrun
   processes on the card (gloo), `flagship-2d` at full width and depth
   (160x192, 5 / 4 levels, n0 32, bf16; its 10-line coarsest level
   replicated): the forward in bf16 and f32 held as 11a's, the step
   at B = 1 in bf16 and f32 and the 2D OASIS Dice step in bf16 at B = 2
   held as 11b's and 11d's (also within twice the unsharded step's
   distance from the same step on the CPU in f32, from its f32 twin in
   bf16), one
   `make_spatial_train_step` update; exact launch counts on each rank,
   each rank's time, peak and exchanged bytes beside the unsharded
   run's.

Each path's launch counts are set to 0 just before it runs and read
just after.

It prints one JSON line of kernel records, the card line, and as its
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_SAMPLES = 32
N_REQUESTS = 3
TRAIN_STEPS = 5                # timed, after one warm-up step
FLAGSHIP = dict(input_size=(160, 192, 224), total_levels=5, latent_levels=4,
                n0=32, compute_dtype="bfloat16", df_resolution="level_res",
                dataset="synthetic")
# the LungCT configuration: the flagship network (the CLI defaults) on
# the converted store's volume (pulpo_tpu/data/lungct.py:70), with the
# routing pair the JAX CLI writes for it (inert in the port)
LUNGCT = dict(FLAGSHIP, input_size=(192, 192, 208), dataset="lungct", lms=True,
              routing=(("PULPO_WARP_COARSE", "1"),))
LUNGCT_PAIRS = 2               # pairs per split
LUNGCT_LANDMARKS = 8           # on the test split
LUNGCT_STEPS = 4               # Trainer steps
LUNGCT_SAMPLES = 10            # N of the uncertainty table
TIME_REPEATS = 5               # timed repeats per kernel time (the median)
SI_RAMP = 16.0                 # voxels, toward the last slices
DRIFT = 4.0                    # voxels, in plane
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # dense tensor-core peak, published

# the full-resolution UQ request on the channels-first field layout: the
# flagship network with full-res dfs and the default feedback less
# "transformed" (the configuration in which the JAX package's batched
# post-loop warp and CF pipeline run)
FULLRES_FEEDBACK = ("samples", "velocity_fields", "individual_dfs", "combined_dfs",
                    "final_dfs")
FULLRES_KW = dict(df_resolution="full_res", feedback=FULLRES_FEEDBACK)
FLAGSHIP_FULLRES = dict(FLAGSHIP, **FULLRES_KW)

# the 2D configuration (`flagship-2d`): the flagship network on the
# 160x192 slice of the public neurite-OASIS 2D release (the 2D form of
# the flagship's OASIS volumes); synthetic pairs from the seed
FLAGSHIP_2D = dict(FLAGSHIP, input_size=(160, 192))
CLI_2D_STEPS = 2               # train_cli steps on its synthetic 2D default (64x64)

# the flagship's own OASIS path: the flagship network with the one-hot
# segmentations (36 classes, pulpo_tpu/data/convert.py:100) and the Dice
# term at the reference's weight (SURVEY.md:177); in-memory stores with
# the readers' layout (the card's machine has no h5py)
SEG_CLASSES = 36
OASIS = dict(FLAGSHIP, dataset="oasis", segs=True, lms=True, recon_loss=("ncc", "dice"),
             dice_factor=50)
OASIS_SPLITS = (4, 2, 2, 2)    # training, validation, test_seg, test_lm pairs
OASIS_LANDMARKS = 8            # on test_lm
OASIS_STEPS = 4                # Trainer steps, B = 1
OASIS_SAMPLES = 10             # N of the uncertainty tables
OASIS_2D_STEPS = 2             # train_cli --ndims 2 --dataset oasis steps
BRATS_SIZE = (144, 192, 160)   # the converted BraTS volume (pulpo_tpu/data/brats.py)
BRATS_SPLITS = (2, 2, 2)       # training, validation, test cases
BRATS_STEPS = 2                # train_cli (its defaults: --dataset brats) steps

KERNELS = ("warp", "squaring", "vel_head", "warp_dfgrad", "warp_mgrad",
           "squaring_bwd", "box_sum", "pos_head", "conv_chain", "squaring_cf", "warp_cf",
           "conv_narrow", "squaring_2d", "warp_2d", "box_sum_2d")
# bf16 tolerance of the eval conv chains: an intermediate of a chained
# unit that rounds the other way moves an output by about a bf16 ulp at
# its scale (2**-7 of it at most); 4 such ulps
BF16_CHAIN_REL = 4 * 2.0**-7
REPLACES = {
    "warp": "pulpo_tpu/kernels/warp_halo.py:322, pulpo_tpu/kernels/warp_halo.py:554",
    "squaring": "pulpo_tpu/kernels/warp_local.py:142",
    "vel_head": "pulpo_tpu/kernels/vel_head.py:185",
    "warp_dfgrad": "pulpo_tpu/kernels/warp_halo.py:822",
    "warp_mgrad": "pulpo_tpu/kernels/warp_halo.py:1004",
    "squaring_bwd": "pulpo_tpu/kernels/warp_local.py:309",
    "box_sum": "pulpo_tpu/kernels/box_sum.py:61",
    "pos_head": "pulpo_tpu/kernels/pos_head.py:272",
    "conv_chain": "pulpo_tpu/attic/conv_chain.py:202",
    "squaring_cf": "pulpo_tpu/kernels/warp_local.py:603",
    "warp_cf": "pulpo_tpu/kernels/warp_halo.py:1560",
    "conv_narrow": "pulpo_tpu/attic/conv_narrow.py:125",
    "squaring_2d": "pulpo_tpu/kernels/warp_local.py:190",
    # no Pallas kernel: the JAX package's 2D warp is an XLA gather
    "warp_2d": "pulpo_tpu/ops/warp.py:56",
    "box_sum_2d": "pulpo_tpu/kernels/box_sum.py:65",
}
SOURCES = {
    "warp": "pulpo_tpu_torch/csrc/warp.cu",
    "squaring": "pulpo_tpu_torch/csrc/squaring.cu",
    "vel_head": "pulpo_tpu_torch/csrc/vel_head.cu",
    "warp_dfgrad": "pulpo_tpu_torch/csrc/warp_bwd.cu",
    "warp_mgrad": "pulpo_tpu_torch/csrc/warp_bwd.cu",
    "squaring_bwd": "pulpo_tpu_torch/csrc/squaring_bwd.cu",
    "box_sum": "pulpo_tpu_torch/csrc/box_sum.cu",
    "pos_head": "pulpo_tpu_torch/csrc/conv_unit.cu",
    "conv_chain": "pulpo_tpu_torch/csrc/conv_unit.cu",
    "squaring_cf": "pulpo_tpu_torch/csrc/squaring.cu",
    "warp_cf": "pulpo_tpu_torch/csrc/warp.cu",
    "conv_narrow": "pulpo_tpu_torch/csrc/conv_narrow.cu",
    "squaring_2d": "pulpo_tpu_torch/csrc/squaring.cu",
    "warp_2d": "pulpo_tpu_torch/csrc/warp.cu",
    "box_sum_2d": "pulpo_tpu_torch/csrc/box_sum.cu",
}


def reset_counts() -> None:
    from pulpo_tpu_torch.kernels import (box_sum, conv_chain, conv_narrow, pos_head, squaring,
                                         vel_head, warp)

    for mod in (warp, squaring, vel_head, box_sum, pos_head, conv_chain, conv_narrow):
        mod.reset_count()


def read_counts() -> dict[str, int]:
    from pulpo_tpu_torch.kernels import (box_sum, conv_chain, conv_narrow, pos_head, squaring,
                                         vel_head, warp)

    return {"warp": warp.launches, "squaring": squaring.launches,
            "vel_head": vel_head.launches, "warp_dfgrad": warp.dfgrad_launches,
            "warp_mgrad": warp.mgrad_launches, "squaring_bwd": squaring.bwd_launches,
            "box_sum": box_sum.launches, "pos_head": pos_head.launches,
            "conv_chain": conv_chain.launches, "squaring_cf": squaring.cf_launches,
            "warp_cf": warp.cf_launches, "conv_narrow": conv_narrow.launches,
            "squaring_2d": squaring.launches_2d, "warp_2d": warp.launches_2d,
            "box_sum_2d": box_sum.launches_2d}


def eval_launches(cfg, encodes, decodes):
    """Launches of the eval conv-chain kernels: per decode 4 for each
    non-coarsest latent level's posterior head; per encode one per unit
    of each down block whose input has at most 8 channels (down_block_0,
    3 units, in the flagship and LungCT configurations)."""
    from pulpo_tpu_torch.kernels import conv_chain

    cins = [2] + [cfg.num_channels[k] for k in range(cfg.total_levels - 1)]
    narrow = sum(c <= conv_chain.MAX_CIN for c in cins)
    return {"pos_head": 4 * (cfg.latent_levels - 1) * decodes,
            "conv_chain": 3 * narrow * encodes}


def train_narrow_launches(cfg):
    """Launches of the narrow-conv kernel per training step: the first
    conv of each down block whose input has at most 4 channels
    (down_block_0, the concatenated pair) and of each latent level's
    velocity head (zdim -> n0), which runs its plain ConvUnit chain in
    train mode. In eval both sit inside the fused kernels: 0. The kernel
    is 3D: a 2D network runs none."""
    from pulpo_tpu_torch.kernels import conv_narrow

    if cfg.ndims != 3:
        return 0
    cins = [2] + [cfg.num_channels[k] for k in range(cfg.total_levels - 1)]
    heads = cfg.latent_levels if (cfg.cp_depth >= 2 and cfg.zdim <= conv_narrow.MAX_CIN) else 0
    return sum(c <= conv_narrow.MAX_CIN for c in cins) + heads


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------

def smooth_field(rows, size, magnitude, seed, device, channels=3):
    """A smooth random field (rows, *size, channels) with max |v| =
    magnitude: coarse normal noise, trilinearly upsampled."""
    import torch

    from pulpo_tpu_torch.ops.resize import resize_linear

    g = torch.Generator().manual_seed(seed)
    coarse = [max(2, s // 16) for s in size]
    v = torch.randn((rows, *coarse, channels), generator=g).to(device)
    v = resize_linear(v, tuple(size))
    return (v * (magnitude / v.abs().max())).contiguous()


def permuted(v):
    """The same values with channels-first memory (strides of a view)."""
    return v.movedim(-1, 1).contiguous().movedim(1, -1)


def respiratory_displacement(points, size, si, drift):
    """A breathing motion at voxel coordinates `points` (..., 3) of a
    volume of `size`: along axis 0 a superior-inferior ramp
    -si * (z / (S0 - 1))**2, strongest at the centre of each slice, so
    the last slices read up to `si` voxels back; in plane a drift of up
    to `drift` voxels that grows with z."""
    import torch

    z, y, x = (points[..., i] / (size[i] - 1) for i in range(3))
    centre = 0.75 + 0.25 * torch.cos(math.pi * (y - 0.5)) * torch.cos(math.pi * (x - 0.5))
    return torch.stack([-si * z**2 * centre,
                        drift * z * torch.sin(2 * math.pi * x),
                        drift * z * torch.cos(math.pi * y)], -1)


def respiratory_field_2d(size, si, drift, device):
    """The breathing motion of a coronal slice (axis 0 superior-inferior,
    axis 1 left-right) of `size`: a df (1, *size, 2) with the ramp
    -si * (z / (S0 - 1))**2 * (0.75 + 0.25 * cos(pi * (y - 0.5))) and an
    in-plane drift of up to `drift` voxels that grows with z."""
    import torch

    z, y = (torch.arange(s, device=device, dtype=torch.float32) / (s - 1) for s in size)
    z, y = z[:, None], y[None, :]
    centre = 0.75 + 0.25 * torch.cos(math.pi * (y - 0.5))
    return torch.stack([-si * z**2 * centre, drift * z * torch.sin(2 * math.pi * y)],
                       -1)[None].contiguous()


def respiratory_field(size, si, drift, device):
    """The breathing motion on the voxel grid: a df (1, *size, 3)."""
    import torch

    axes = [torch.arange(s, device=device, dtype=torch.float32) for s in size]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    return respiratory_displacement(grid, size, si, drift)[None].contiguous()


def head_params(zdim, n0, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    r = lambda shape, s=1.0: (torch.randn(shape, generator=g) * s).to(device)
    return {
        "k1": r((n0, zdim, 3, 3, 3), 0.3), "b1": r((n0,), 0.1),
        "mean1": r((n0,), 0.5), "var1": r((n0,)).abs() + 0.1,
        "scale1": r((n0,)) + 1.0, "bias1": r((n0,), 0.2),
        "k2": r((n0, n0, 3, 3, 3), 0.2 / math.sqrt(n0 / 8)), "b2": r((n0,), 0.1),
        "mean2": r((n0,), 0.5), "var2": r((n0,)).abs() + 0.1,
        "scale2": r((n0,)) + 1.0, "bias2": r((n0,), 0.2),
        "k3": r((3, n0, 1, 1, 1), 0.5), "b3": r((3,), 0.1),
    }


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

class Checks:
    """The kernel-versus-plain comparisons: the worst error per kernel and
    the cases that failed."""

    def __init__(self):
        self.worst = {k: 0.0 for k in KERNELS}
        self.failures = []

    def record(self, name, case, got, ref, tol):
        import torch

        err = float((got.float() - ref.float()).abs().max())
        self.worst[name] = max(self.worst[name], err)
        ok = err <= tol and bool(torch.isfinite(got).all())
        log(f"check {name:12s} {case:44s} max_abs_err {err:.3e}  tol {tol:.1e}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {case}")


def scaled(ref, rel):
    """A tolerance of `rel` times the reference's scale (at least 1)."""
    return rel * max(1.0, float(ref.float().abs().max()))


def check_kernels(dev, full, level0, checks, rows=4):
    """The serving path's kernels against their plain versions. `full`:
    input size; `level0`: latent level-0 size."""
    import torch

    from pulpo_tpu_torch.kernels import squaring, warp

    record = checks.record
    g = torch.Generator().manual_seed(0)
    img = torch.rand((1, *full, 1), generator=g).to(dev)
    img3 = torch.rand((1, *level0, 3), generator=g).to(dev)
    # warp: image tolerance 1e-5 (values in [0, 1]; same operations in
    # the same order, so differences are summation-order noise)
    for mag in (0.3, 3.0, 15.0):
        df = smooth_field(rows, full, mag, seed=int(mag * 10), device=dev)
        record("warp", f"C=1 {rows} rows |d|<={mag}", warp.warp(img, df),
               warp.warp_plain(img, df), 1e-5)
    df = smooth_field(rows, full, 3.0, seed=7, device=dev)
    df[..., 0] += 60.0
    df[:, :, :8, :, 2] -= 80.0
    record("warp", "C=1 border clamp", warp.warp(img, df), warp.warp_plain(img, df), 1e-5)
    df = smooth_field(rows, level0, 3.0, seed=8, device=dev)
    record("warp", f"C=3 {rows} rows", warp.warp(img3, df), warp.warp_plain(img3, df), 1e-5)
    df = smooth_field(2, level0, 3.0, seed=9, device=dev)
    record("warp", "cross-res moving full, df level0", warp.warp(img, df),
           warp.warp_plain(img, df), 1e-5)

    # squaring: 7-step integration; early-step rounding noise doubles
    # per step, so the tolerance scales with the field (as the JAX
    # package's own integration test)
    for mag in (2.0, 40.0):
        v = smooth_field(rows, level0, mag, seed=int(mag), device=dev)
        ref = squaring.integrate_svf_plain(v, 7)
        got = squaring.integrate_svf(v, 7)
        record("squaring", f"7 steps {rows} rows |v|<={mag}", got, ref,
               1e-4 * float(ref.abs().max()) + 1e-4)
    # a permuted-memory input, as the decode's resized fields are
    v = permuted(smooth_field(rows, level0, 2.0, seed=5, device=dev))
    ref = squaring.integrate_svf_plain(v, 7)
    record("squaring", "7 steps permuted-memory input", squaring.integrate_svf(v, 7),
           ref, 1e-4 * float(ref.abs().max()) + 1e-4)
    df = permuted(smooth_field(rows, full, 3.0, seed=6, device=dev))
    record("warp", "C=1 permuted-memory df", warp.warp(img, df), warp.warp_plain(img, df), 1e-5)
    # a base 4 bytes past a 16-byte boundary: the gathers' scalar path,
    # the same operations as the 16-byte one (bit-equal)
    df = smooth_field(rows, level0, 3.0, seed=16, device=dev)
    img0 = torch.rand((1, *level0, 1), generator=g).to(dev)
    record("warp", f"C=1 {rows} rows misaligned df", warp.warp(misaligned(img0), misaligned(df)),
           warp.warp(img0, df), 0.0)
    v = smooth_field(rows, level0, 2.0, seed=17, device=dev)
    record("squaring", "one step misaligned field", squaring.squaring_step(
        misaligned(v), misaligned(torch.empty_like(v))), squaring.squaring_step(v), 0.0)
    check_vel_head(dev, level0, checks, g, rows=N_SAMPLES)


def misaligned(t):
    """The same values in contiguous memory 4 bytes past a 16-byte
    boundary."""
    import torch

    buf = torch.empty(t.numel() + 4, device=t.device, dtype=t.dtype)
    skip = (4 - (buf.data_ptr() // 4) % 4) % 4 + 1
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_vel_head(dev, level0, checks, g, rows=None):
    """The velocity head at latent level 0, n0 = 32, zdim = 3, on 2 rows
    and, given `rows`, in bf16 on that many (the request's chunk: the
    persistent grid at the size phase 6 times). f32: summation order
    only -> 1e-4 of the output scale; bf16: an intermediate that rounds
    the other way moves an output by a few bf16 ulps (2**-8 of the output
    scale each) -> 2% of the output scale."""
    import torch

    from pulpo_tpu_torch.kernels import vel_head

    p = head_params(3, 32, seed=3, device=dev)
    cases = [(torch.float32, "f32", 1e-4, 2), (torch.bfloat16, "bf16", 0.02, 2)]
    for dt, name, rel, n in cases + ([(torch.bfloat16, "bf16", 0.02, rows)] if rows else []):
        z = torch.randn((n, *level0, 3), generator=g).to(dev, dt)
        ref = vel_head.velocity_head_plain(z, p)
        got = vel_head.velocity_head(z, p)
        scale = max(1.0, float(ref.float().abs().max()))
        checks.record("vel_head", f"{name} {n} rows n0=32 {'x'.join(map(str, level0))}", got, ref,
                      rel * scale)
        del z, ref, got


def check_backward_kernels(dev, cfg, checks):
    """The training path's kernels against their plain versions at its
    shapes (B = 1). `warp_mgrad` and `squaring_bwd` scatter with float32
    atomics, whose order is not fixed: 1e-5 of the output's scale.
    `warp_dfgrad` (C = 1) repeats the plain version's operations and
    `box_sum` adds in its order: both bit-equal."""
    import torch

    from pulpo_tpu_torch.kernels import squaring, warp

    record = checks.record
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    g = torch.Generator().manual_seed(1)
    img = torch.rand((1, *full, 1), generator=g).to(dev)

    # df-cotangent at level 0: full-res image, full-res df (level_res
    # resizes the level-0 df to the input size), C = 1
    for mag in (0.3, 3.0, 15.0):
        df = smooth_field(1, full, mag, seed=int(mag * 10) + 1, device=dev)
        cot = torch.randn((1, *full, 1), generator=g).to(dev)
        ref = warp.warp_dfgrad_plain(img, df, cot)
        record("warp_dfgrad", f"C=1 full res |d|<={mag}", warp.warp_dfgrad(img, df, cot),
               ref, 0.0)
    df[..., 0] += 60.0
    df[:, :, :8, :, 2] -= 80.0
    ref = warp.warp_dfgrad_plain(img, df, cot)
    record("warp_dfgrad", "C=1 full res border clamp", warp.warp_dfgrad(img, df, cot),
           ref, 0.0)
    df = permuted(smooth_field(2, full, 3.0, seed=21, device=dev))
    cot = torch.randn((2, *full, 1), generator=g).to(dev)
    ref = warp.warp_dfgrad_plain(img, df, cot)
    record("warp_dfgrad", "C=1 2 rows permuted-memory df", warp.warp_dfgrad(img, df, cot),
           ref, 0.0)
    # the full-size image under 2 rows of a level-0 df (a cross-resolution warp)
    df = smooth_field(2, level0, 3.0, seed=25, device=dev)
    cot = torch.randn((2, *level0, 1), generator=g).to(dev)
    ref = warp.warp_dfgrad_plain(img, df, cot)
    record("warp_dfgrad", f"C=1 2 rows {'x'.join(map(str, level0))} df, full-res image",
           warp.warp_dfgrad(img, df, cot), ref, 0.0)
    del df, cot, ref

    # moving-cotangent: level 0 with C = 3 (its role in the squaring
    # backward), and full res with C = 1
    for size, c, rows in ((level0, 3, 1), (level0, 3, 2), (full, 1, 1)):
        df = smooth_field(rows, size, 3.0, seed=22 + rows, device=dev)
        cot = torch.randn((rows, *size, c), generator=g).to(dev)
        ref = warp.warp_mgrad_plain((1, *size, c), df, cot)
        record("warp_mgrad", f"C={c} {rows} rows {'x'.join(map(str, size))}",
               warp.warp_mgrad((1, *size, c), df, cot), ref, scaled(ref, 1e-5))
    ref = warp.warp_mgrad_plain((1, *size, c), permuted(df), cot)
    record("warp_mgrad", "C=1 full res permuted-memory df",
           warp.warp_mgrad((1, *size, c), permuted(df), cot), ref, scaled(ref, 1e-5))
    del df, cot, ref

    # squaring backward at level 0: the 7 step inputs of one integration
    # (up to 8 voxels, past the TPU stencil's sub-voxel bound), then the
    # whole backward through IntegrateSVF against the plain chain
    v = smooth_field(1, level0, 8.0, seed=24, device=dev)
    step_in = [v * (1.0 / 2**cfg.nsteps)]
    for _ in range(cfg.nsteps - 1):
        step_in.append(squaring.squaring_step_plain(step_in[-1]))
    cot = torch.randn((1, *level0, 3), generator=g).to(dev)
    for k, vk in enumerate(step_in):
        ref = squaring.squaring_step_bwd_plain(vk, cot)
        record("squaring_bwd", f"step {k} |v|<={float(vk.abs().max()):.2f}",
               squaring.squaring_step_bwd(vk, cot), ref, scaled(ref, 1e-5))
    ref = squaring.squaring_step_bwd_plain(step_in[-1], cot)
    record("squaring_bwd", "step 6 permuted-memory field",
           squaring.squaring_step_bwd(permuted(step_in[-1]), cot), ref, scaled(ref, 1e-5))
    ref = cot
    for vk in reversed(step_in):
        ref = squaring.squaring_step_bwd_plain(vk, ref)
    ref = ref * (1.0 / 2**cfg.nsteps)
    vg = v.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(squaring.integrate_svf(vg, cfg.nsteps), vg, cot)
    record("squaring_bwd", "IntegrateSVF backward, 7 steps", got, ref, scaled(ref, 1e-4))
    del v, vg, step_in, cot, ref, got
    check_box_sums(dev, cfg, checks, g)


def check_box_sums(dev, cfg, checks, g):
    """The NCC's box sum at each level's recon size with its own window
    (full res with window 9 at level 0), and a permuted-memory input:
    bit-equal to the plain version (the kernel keeps its order of adds)."""
    import torch

    from pulpo_tpu_torch.kernels import box_sum

    fmt = lambda size: "x".join(map(str, size))
    for l in range(cfg.latent_levels):
        size, win = cfg.df_size(l), cfg.window_size[l]
        x = torch.rand((1, *size), generator=g).to(dev)
        ref = box_sum.box_sum_plain(x, win)
        checks.record("box_sum", f"level {l} {fmt(size)} win {win}", box_sum.box_sum(x, win),
                      ref, 0.0)
    x = torch.rand((1, *cfg.input_size), generator=g).to(dev)
    xp = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    ref = box_sum.box_sum_plain(x, 9)
    checks.record("box_sum", f"{fmt(cfg.input_size)} win 9 permuted-memory input",
                  box_sum.box_sum(xp, 9), ref, 0.0)


def check_large_displacement(dev, cfg, checks):
    """Phase 3c: the kernels of the LungCT path under its displacements
    and at its shapes. The warp and its df-cotangent repeat the plain
    version's operations (bit-equal, tolerance 0); the moving-cotangent
    and the squaring backward scatter with float32 atomics (1e-5 of
    scale); the squaring integration is bit-equal; the box sums and the
    velocity head are held as at the flagship's shapes."""
    import torch

    from pulpo_tpu_torch.kernels import squaring, warp

    record = checks.record
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    g = torch.Generator().manual_seed(3)
    img = torch.rand((1, *full, 1), generator=g).to(dev)
    df = respiratory_field(full, SI_RAMP, DRIFT, dev)
    tag = f"{'x'.join(map(str, full))} ramp {SI_RAMP:g}"
    record("warp", f"C=1 {tag}", warp.warp(img, df), warp.warp_plain(img, df), 0.0)
    record("warp", f"C=1 {tag} permuted-memory df", warp.warp(img, permuted(df)),
           warp.warp_plain(img, df), 0.0)
    cot = torch.randn((1, *full, 1), generator=g).to(dev)
    ref = warp.warp_dfgrad_plain(img, df, cot)
    record("warp_dfgrad", f"C=1 {tag}", warp.warp_dfgrad(img, df, cot), ref, 0.0)
    record("warp_dfgrad", f"C=1 {tag} permuted-memory df",
           warp.warp_dfgrad(img, permuted(df), cot), ref, 0.0)
    del img, df, cot, ref

    # level 0: moving-cotangent (C = 3, its role in the squaring backward)
    tag0 = f"{'x'.join(map(str, level0))} ramp {SI_RAMP:g}"
    df = respiratory_field(level0, SI_RAMP, DRIFT, dev)
    cot = torch.randn((1, *level0, 3), generator=g).to(dev)
    shape = (1, *level0, 3)
    ref = warp.warp_mgrad_plain(shape, df, cot)
    record("warp_mgrad", f"C=3 {tag0}", warp.warp_mgrad(shape, df, cot), ref, scaled(ref, 1e-5))
    record("warp_mgrad", f"C=3 {tag0} permuted-memory df",
           warp.warp_mgrad(shape, permuted(df), cot), ref, scaled(ref, 1e-5))

    # an SVF whose last squaring step moves ~8 voxels: its 7 step inputs,
    # the integration (bit-equal) and the backward of each step
    v = respiratory_field(level0, SI_RAMP / 2, DRIFT / 2, dev)
    ref = squaring.integrate_svf_plain(v, cfg.nsteps)
    record("squaring", f"7 steps {'x'.join(map(str, level0))} |phi|<={float(ref.abs().max()):.2f}",
           squaring.integrate_svf(v, cfg.nsteps), ref, 0.0)
    record("squaring", "7 steps ramp permuted-memory input",
           squaring.integrate_svf(permuted(v), cfg.nsteps), ref, 0.0)
    step_in = [v * (1.0 / 2**cfg.nsteps)]
    for _ in range(cfg.nsteps - 1):
        step_in.append(squaring.squaring_step_plain(step_in[-1]))
    for k, vk in enumerate(step_in):
        ref = squaring.squaring_step_bwd_plain(vk, cot)
        record("squaring_bwd", f"ramp step {k} |v|<={float(vk.abs().max()):.2f}",
               squaring.squaring_step_bwd(vk, cot), ref, scaled(ref, 1e-5))
    ref = squaring.squaring_step_bwd_plain(step_in[-1], cot)
    record("squaring_bwd", "ramp step 6 permuted-memory field",
           squaring.squaring_step_bwd(permuted(step_in[-1]), cot), ref, scaled(ref, 1e-5))
    del v, step_in, cot, ref

    # the NCC's box sums and the eval head at the LungCT levels' sizes,
    # whose odd depths (208 down to 13) the flagship never has
    check_box_sums(dev, cfg, checks, g)
    check_vel_head(dev, level0, checks, g)


# ----------------------------------------------------------------------
# phase 3d: the eval conv chains (conv-unit kernel)
# ----------------------------------------------------------------------

def eval_unit(cin, cout, g, dev):
    """One ConvUnit's parameters (PyTorch layout): a unit-variance conv
    and BatchNorm statistics away from the default init's 0 and 1, which
    would hide an error in the BatchNorm."""
    import torch

    r = lambda shape, s=1.0: (torch.randn(shape, generator=g) * s).to(dev)
    return {"k": r((cout, cin, 3, 3, 3), 1.0 / math.sqrt(27 * cin)), "b": r((cout,), 0.1),
            "mean": r((cout,), 0.3), "var": r((cout,)).abs() + 0.2,
            "scale": r((cout,)) + 1.0, "bias": r((cout,), 0.2)}


def pos_head_widths(cfg, l):
    """(c_fb, n_up, n_merge) of latent level l's posterior head."""
    from pulpo_tpu_torch.models.pulpo import feedback_channels

    return feedback_channels(cfg), cfg.n0 * cfg.zdim, cfg.num_channels[cfg.lk_offset + l]


def pos_head_params(widths, zdim, seed, dev):
    import torch

    c_fb, n_up, n_merge = widths
    g = torch.Generator().manual_seed(seed)
    p = {}
    for pre, n, cin, cout in (("u", 1, c_fb, n_up), ("u", 2, n_up, n_up),
                              ("m", 1, n_up, n_merge), ("m", 2, n_merge, n_merge)):
        p.update({f"{pre}{k}{n}": v for k, v in eval_unit(cin, cout, g, dev).items()})
    for h in ("mu", "sig"):
        p[f"hk{h}"] = (torch.randn((zdim, n_merge, 1, 1, 1), generator=g)
                       / math.sqrt(n_merge)).to(dev)
        p[f"hb{h}"] = (torch.randn((zdim,), generator=g) * 0.1).to(dev)
    return p


def chain_stages(widths, seed, dev):
    import torch

    g = torch.Generator().manual_seed(seed)
    return [eval_unit(widths[i], widths[i + 1], g, dev) for i in range(len(widths) - 1)]


def eval_tolerances():
    """(dtype, name, relative tolerance): float32 sums in another order
    only, 1e-4 of the output's scale; bfloat16 BF16_CHAIN_REL."""
    import torch

    return ((torch.float32, "f32", 1e-4), (torch.bfloat16, "bf16", BF16_CHAIN_REL))


def check_eval_kernels(dev, checks):
    """Phase 3d: the posterior head at every non-coarsest latent level of
    the flagship and LungCT (R = 4 rows over B = 1), the conv chain on
    down_block_0 at both full sizes, both dtypes; the eval kernels'
    gradients."""
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import conv_chain, pos_head

    fmt = lambda size: "x".join(map(str, size))
    gd = torch.Generator(device=dev).manual_seed(60)
    for seed, cfg_kw in enumerate((FLAGSHIP, LUNGCT)):
        cfg = PULPoConfig(**cfg_kw)
        for l in range(cfg.latent_levels - 1):
            widths = pos_head_widths(cfg, l)
            size = cfg.level_sizes[l]
            p = pos_head_params(widths, cfg.zdim, 61 + 10 * seed + l, dev)
            for dt, name, rel in eval_tolerances():
                fb = torch.randn((4, *size, widths[0]), generator=gd, device=dev).to(dt)
                y2 = torch.randn((1, *size, widths[2]), generator=gd, device=dev).to(dt)
                got = pos_head.posterior_head(fb, y2, p)
                ref = pos_head.posterior_head_plain(fb, y2, p)
                for what, a, b in zip(("mu", "sigma"), got, ref):
                    checks.record("pos_head", f"{name} {what} 4 rows {fmt(size)} "
                                  f"{'/'.join(map(str, widths))}", a, b, scaled(b, rel))
                del fb, y2, got, ref
        torch.cuda.empty_cache()
    cfg = PULPoConfig(**FLAGSHIP)
    widths, size = pos_head_widths(cfg, 1), cfg.level_sizes[1]
    p = pos_head_params(widths, cfg.zdim, 70, dev)
    fb = torch.randn((4, *size, widths[0]), generator=gd, device=dev)
    y2 = torch.randn((1, *size, widths[2]), generator=gd, device=dev)
    for what, a, b in zip(("mu", "sigma"), pos_head.posterior_head(permuted(fb), permuted(y2), p),
                          pos_head.posterior_head_plain(fb, y2, p)):
        checks.record("pos_head", f"f32 {what} permuted-memory fb and y2 {fmt(size)}", a, b,
                      scaled(b, 1e-4))
    del fb, y2

    for cfg_kw in (FLAGSHIP, LUNGCT):
        cfg = PULPoConfig(**cfg_kw)
        stages = chain_stages((2, cfg.n0, cfg.n0, cfg.n0), 71, dev)
        for dt, name, rel in eval_tolerances():
            x = torch.rand((1, *cfg.input_size, 2), generator=gd, device=dev).to(dt)
            ref = conv_chain.conv_chain_plain(x, stages)
            checks.record("conv_chain", f"{name} down_block_0 {fmt(cfg.input_size)}x2",
                          conv_chain.conv_chain(x, stages), ref, scaled(ref, rel))
            del x, ref
        torch.cuda.empty_cache()
    check_eval_gradients(dev, checks)


def check_eval_gradients(dev, checks):
    """The gradient of sum(out * g) through each eval kernel's wrapper on
    the card, for the input and every weight, against the plain
    version's (float32; 1e-5 of each gradient's scale: the backward
    replays the plain version, so only the forward's sums differ)."""
    import torch

    from pulpo_tpu_torch.kernels import conv_chain, pos_head, vel_head
    from pulpo_tpu_torch.kernels.conv_unit import UNIT_KEYS

    def grads(fn, tensors):
        xs = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        g = torch.Generator(device=dev).manual_seed(80)
        loss = sum((o * torch.randn(o.shape, generator=g, device=dev)).sum() for o in outs)
        return torch.autograd.grad(loss, xs)

    gd = torch.Generator(device=dev).manual_seed(81)
    cases = []
    p = head_params(3, 32, seed=82, device=dev)
    vk = sorted(p)
    cases.append(("vel_head", lambda z, *v: vel_head.velocity_head(z, dict(zip(vk, v))),
                  lambda z, *v: vel_head.velocity_head_plain(z, dict(zip(vk, v))),
                  [torch.randn((2, 10, 12, 14, 3), generator=gd, device=dev)]
                  + [p[k] for k in vk]))
    p = pos_head_params((16, 96, 64), 3, 83, dev)
    pk = pos_head.KEYS
    cases.append(("pos_head", lambda f, y, *v: pos_head.posterior_head(f, y, dict(zip(pk, v))),
                  lambda f, y, *v: pos_head.posterior_head_plain(f, y, dict(zip(pk, v))),
                  [torch.randn((4, 10, 12, 14, 16), generator=gd, device=dev),
                   torch.randn((1, 10, 12, 14, 64), generator=gd, device=dev)]
                  + [p[k] for k in pk]))
    stages = chain_stages((2, 32, 32, 32), 84, dev)
    n = len(UNIT_KEYS)
    st = lambda v: [dict(zip(UNIT_KEYS, v[i:i + n])) for i in range(0, len(v), n)]
    cases.append(("conv_chain", lambda x, *v: conv_chain.conv_chain(x, st(v)),
                  lambda x, *v: conv_chain.conv_chain_plain(x, st(v)),
                  [torch.rand((1, 10, 12, 14, 2), generator=gd, device=dev)]
                  + [u[k] for u in stages for k in UNIT_KEYS]))
    for name, kernel, plain, tensors in cases:
        got, ref = grads(kernel, tensors), grads(plain, tensors)
        worst = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(got, ref))
        ok = all(a is not None for a in got) and worst <= 1e-5
        log(f"check {name:12s} gradient of {len(tensors)} inputs vs plain: worst scaled "
            f"err {worst:.3e}  tol 1.0e-05  {'ok' if ok else 'FAIL'}")
        if not ok:
            checks.failures.append(f"{name} gradient")


# ----------------------------------------------------------------------
# phase 3e: the channels-first kernels and the narrow conv
# ----------------------------------------------------------------------

def check_cf_kernels(dev, checks, chunk=N_SAMPLES):
    """The CF squaring and the CF warp against their channels-last twins,
    bit for bit (tolerance 0: the same operations in the same order), and
    against their plain versions: the integration on `chunk` rows at the
    flagship's level 0 (80x96x112) and under LungCT's respiratory field
    at its level 0 (96x96x104); the batched image warp on 4 x `chunk`
    rows at 160x192x224. Each again with non-contiguous inputs (CF
    shapes over channels-last memory)."""
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import squaring, warp

    record = checks.record
    fmt = lambda size: "x".join(map(str, size))
    cfg = PULPoConfig(**FLAGSHIP_FULLRES)
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    cf = lambda v: v.permute(0, 4, 1, 2, 3)
    cl = lambda v: v.permute(0, 2, 3, 4, 1)

    v = smooth_field(chunk, level0, 2.0, seed=100, device=dev)  # channels-last memory
    v_cf = cf(v).contiguous()
    ref = squaring.integrate_svf(v, cfg.nsteps)
    record("squaring_cf", f"7 steps {chunk} rows {fmt(level0)} vs CL kernel",
           cl(squaring.integrate_svf_cf(v_cf, cfg.nsteps)), ref, 0.0)
    record("squaring_cf", "7 steps non-contiguous CF input vs CL kernel",
           cl(squaring.integrate_svf_cf(cf(v), cfg.nsteps)), ref, 0.0)
    one = v_cf[:4] * (1.0 / 2**cfg.nsteps)
    record("squaring_cf", "one step 4 rows vs plain", squaring.squaring_step_cf(one),
           squaring.squaring_step_cf_plain(one), 0.0)
    del v, v_cf, ref, one
    lung = PULPoConfig(**LUNGCT)
    v = respiratory_field(lung.level_sizes[0], SI_RAMP / 2, DRIFT / 2, dev)
    ref = squaring.integrate_svf_plain(v, lung.nsteps)
    tag = f"7 steps {fmt(lung.level_sizes[0])} ramp |phi|<={float(ref.abs().max()):.2f}"
    record("squaring_cf", f"{tag} vs plain", cl(squaring.integrate_svf_cf(cf(v).contiguous(),
                                                                          lung.nsteps)), ref, 0.0)
    record("squaring_cf", f"{tag} non-contiguous vs CL kernel",
           cl(squaring.integrate_svf_cf(cf(v), lung.nsteps)),
           squaring.integrate_svf(v, lung.nsteps), 0.0)
    del v, ref
    torch.cuda.empty_cache()

    # the decode's batched image warp: 4 levels x `chunk` rows of full-res
    # dfs, one moving image; each level's rows at another magnitude
    g = torch.Generator().manual_seed(101)
    img = torch.rand((1, *full, 1), generator=g).to(dev)
    base = smooth_field(chunk, full, 1.0, seed=102, device=dev)
    df_cf = torch.cat([cf(base * m) for m in (0.3, 1.0, 3.0, 15.0)]).contiguous()
    del base
    got = warp.warp_cf(cf(img), df_cf)
    ref = warp.warp(img, cl(df_cf))  # the CL kernel copies the view to CL memory
    record("warp_cf", f"C=1 {df_cf.shape[0]} rows {fmt(full)} vs CL kernel", cl(got), ref, 0.0)
    del ref
    record("warp_cf", "C=1 4 rows vs plain", got[::chunk], warp.warp_cf_plain(cf(img), df_cf[::chunk]),
           0.0)
    df_cl = cl(df_cf).contiguous()
    del df_cf
    torch.cuda.empty_cache()
    record("warp_cf", f"C=1 {df_cl.shape[0]} rows non-contiguous df vs CF kernel",
           warp.warp_cf(cf(img), cf(df_cl)), got, 0.0)
    del df_cl, got
    torch.cuda.empty_cache()
    # C = 3 (a field warped by a field, as the squaring's inner warp)
    m = smooth_field(2, level0, 1.0, seed=103, device=dev)
    d = smooth_field(4, level0, 6.0, seed=104, device=dev)
    ref = warp.warp(m, d)
    record("warp_cf", f"C=3 4 rows {fmt(level0)} vs CL kernel",
           cl(warp.warp_cf(cf(m).contiguous(), cf(d).contiguous())), ref, 0.0)
    record("warp_cf", "C=3 non-contiguous moving and df vs CL kernel",
           cl(warp.warp_cf(cf(m), cf(d))), ref, 0.0)
    record("warp_cf", "C=3 vs plain", cl(warp.warp_cf(cf(m), cf(d))),
           warp.warp_plain(m, d), 0.0)
    del m, d, ref, img
    torch.cuda.empty_cache()


def narrow_weight(cin, cout, seed, dev):
    import torch

    g = torch.Generator().manual_seed(seed)
    return (torch.randn((cout, cin, 3, 3, 3), generator=g) / math.sqrt(27 * cin)).to(dev)


def narrow_shapes(cfg_kw):
    """(cin, size) of each narrow-conv launch of a training step of a 3D
    configuration: down_block_0's 2 -> n0 at the input size, then each
    latent level's velocity-head conv, zdim -> n0 at its size."""
    from pulpo_tpu_torch import PULPoConfig

    cfg = PULPoConfig(**cfg_kw)
    return [(2, cfg.input_size)] + [(cfg.zdim, cfg.level_sizes[l])
                                    for l in range(cfg.latent_levels)]


def check_conv_narrow(dev, checks):
    """The narrow conv against its plain version, bf16 and f32, at every
    shape a training step of the flagship and LungCT configurations
    launches (2 -> n0 at the input size, zdim -> n0 at each latent
    level), and from a non-contiguous input. bf16 runs on the tensor
    cores, which sum the products in another order: within one bf16 ulp
    at the output's scale. f32 runs on the CUDA cores, repeating the
    plain version's operations: bit-equal. A permuted input gives the
    contiguous one's output bit for bit. Then the gradient (dx, dW)
    through `NarrowConv` against the plain version's autograd (f32, 1e-5
    of scale: the library conv backward sums in another order)."""
    import torch

    from pulpo_tpu_torch.kernels import conv_narrow

    fmt = lambda size: "x".join(map(str, size))
    cases = narrow_shapes(FLAGSHIP) + narrow_shapes(LUNGCT)
    g = torch.Generator(device=dev).manual_seed(110)
    for i, (cin, size) in enumerate(cases):
        w = narrow_weight(cin, 32, 111 + i, dev)
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = torch.randn((1, *size, cin), generator=g, device=dev).to(dt)
            ref = conv_narrow.conv_narrow_plain(x, w)
            scale = max(1.0, float(ref.float().abs().max()))
            tol = 2.0 ** (math.floor(math.log2(scale)) - 7) if dt == torch.bfloat16 else 0.0
            with torch.no_grad():
                got = conv_narrow.conv_narrow(x, w)
                checks.record("conv_narrow", f"{name} {cin}->32 {fmt(size)}", got, ref, tol)
                if i in (0, 1):
                    xp = x.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
                    checks.record("conv_narrow", f"{name} {cin}->32 {fmt(size)} permuted input "
                                  "vs contiguous", conv_narrow.conv_narrow(xp, w), got, 0.0)
            del x, ref, got
        torch.cuda.empty_cache()

    x = torch.randn((2, 10, 12, 14, 3), generator=g, device=dev)
    w = narrow_weight(3, 32, 119, dev)
    cot = torch.randn((2, 10, 12, 14, 32), generator=g, device=dev)

    def grads(fn, need_x=True):
        xs = x.detach().clone().requires_grad_(need_x)
        ws = w.detach().clone().requires_grad_(True)
        return torch.autograd.grad((fn(xs, ws) * cot).sum(), (xs, ws) if need_x else (ws,))

    for need_x in (True, False):
        got, ref = grads(conv_narrow.conv_narrow, need_x), grads(conv_narrow.conv_narrow_plain,
                                                                 need_x)
        worst = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(got, ref))
        ok = worst <= 1e-5
        log(f"check {'conv_narrow':12s} gradient ({'dx, dW' if need_x else 'dW'}) vs plain "
            f"autograd: worst scaled err {worst:.3e}  tol 1.0e-05  {'ok' if ok else 'FAIL'}")
        if not ok:
            checks.failures.append("conv_narrow gradient")


# ----------------------------------------------------------------------
# phase 3f: the 2D kernels
# ----------------------------------------------------------------------

def check_2d_kernels(dev, cfg, checks, rows=N_SAMPLES):
    """The 2D squaring step, warp and box sum against their plain
    versions at the `flagship-2d` path's shapes: each is bit-equal (the
    same operations in the same order, -fmad=false), tolerance 0. The
    squaring step on `rows` fields at each level size, sub-voxel and past
    the TPU stencil's bound (the LungCT ramp scaled to the slice), with
    a 7-step integration and a permuted-memory input; the warp of the
    full-size image by `rows` dfs at the full size and at each level's
    (cross-resolution), with a border clamp and a permuted df; the box
    sum at each level's NCC image size and window."""
    import torch

    from pulpo_tpu_torch.kernels import box_sum, squaring, warp

    record = checks.record
    full = cfg.input_size
    fmt = lambda size: "x".join(map(str, size))
    ramp = lambda size: respiratory_field_2d(size, SI_RAMP * size[0] / full[0],
                                             DRIFT * size[0] / full[0], dev)
    for l, size in cfg.level_sizes.items():
        for tag, v in (("|v|<=0.3", smooth_field(rows, size, 0.3, seed=200 + l, device=dev,
                                                  channels=2)),
                       (f"ramp {SI_RAMP * size[0] / full[0]:g}",
                        ramp(size).expand(rows, -1, -1, -1).contiguous())):
            record("squaring_2d", f"step {rows} rows {fmt(size)} {tag}",
                   squaring.squaring_step(v), squaring.squaring_step_plain(v), 0.0)
        v = ramp(size) * 0.5
        ref = squaring.integrate_svf_plain(v, cfg.nsteps)
        record("squaring_2d", f"7 steps {fmt(size)} ramp/2", squaring.integrate_svf(v, cfg.nsteps),
               ref, 0.0)
        record("squaring_2d", f"7 steps {fmt(size)} ramp/2 permuted-memory input",
               squaring.integrate_svf(permuted(v), cfg.nsteps), ref, 0.0)

    g = torch.Generator().manual_seed(20)
    img = torch.rand((1, *full, 1), generator=g).to(dev)
    for mag in (0.3, 3.0, 15.0):
        df = smooth_field(rows, full, mag, seed=210 + int(mag), device=dev, channels=2)
        record("warp_2d", f"C=1 {rows} rows {fmt(full)} |d|<={mag}", warp.warp(img, df),
               warp.warp_plain(img, df), 0.0)
    df[..., 0] += 40.0
    df[:, :, :8, 1] -= 50.0
    record("warp_2d", "C=1 border clamp", warp.warp(img, df), warp.warp_plain(img, df), 0.0)
    df = permuted(ramp(full).expand(rows, -1, -1, -1))
    record("warp_2d", f"C=1 {fmt(full)} ramp permuted-memory df", warp.warp(img, df),
           warp.warp_plain(img, df), 0.0)
    for l, size in cfg.level_sizes.items():
        df = smooth_field(rows, size, 3.0, seed=220 + l, device=dev, channels=2)
        record("warp_2d", f"cross-res {fmt(full)} -> {fmt(size)} {rows} rows",
               warp.warp(img, df), warp.warp_plain(img, df), 0.0)
    fields = smooth_field(2, cfg.level_sizes[0], 3.0, seed=230, device=dev, channels=2)
    record("warp_2d", "C=2 field by field", warp.warp(fields, fields),
           warp.warp_plain(fields, fields), 0.0)

    for l in range(cfg.latent_levels):
        size, win = cfg.df_size(l), cfg.window_size[l]
        x = torch.rand((1, *size), generator=g).to(dev)
        record("box_sum_2d", f"level {l} {fmt(size)} win {win}", box_sum.box_sum(x, win),
               box_sum.box_sum_plain(x, win), 0.0)
    x = torch.rand((2, *full), generator=g).to(dev)
    record("box_sum_2d", f"2 rows {fmt(full)} win 9 permuted-memory input",
           box_sum.box_sum(x.transpose(1, 2).contiguous().transpose(1, 2), 9),
           box_sum.box_sum_plain(x, 9), 0.0)


# ----------------------------------------------------------------------
# phase 4: small input, card against CPU
# ----------------------------------------------------------------------

def check_small_reference(dev, size=(32, 40, 48), n=4, **cfg_kw):
    """UQ on the card (kernels) against the CPU (plain versions), same
    weights, same draws; every leaf within 1e-3 of its scale. `cfg_kw`
    adds to the small config (the full_res CF path: FULLRES_KW)."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(input_size=size, total_levels=3, latent_levels=2, n0=8, **cfg_kw)
    ref_model = PULPoModel(cfg, device="cpu")
    ref_model.init(5)
    model = PULPoModel(cfg, device=dev)
    model.load_state_dict(ref_model.state_dict())
    pair = SyntheticDataset(shape=size, n=2, seed=1).get_pair(0, np.random.default_rng(0))
    x, y = pair["x"][None], pair["y"][None]
    rng = np.random.default_rng(2)
    noise = {l: torch.from_numpy(rng.standard_normal((n, 1, *cfg.level_sizes[l], cfg.zdim),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    ref = predict_with_uncertainty(ref_model, x, y, n, chunk=2, noise=noise)
    got = predict_with_uncertainty(model, x, y, n, chunk=2, noise=noise)
    worst = 0.0
    for field, d in ref._asdict().items():
        if d is None:
            continue
        for l, r in d.items():
            gl = got._asdict()[field][l].cpu()
            err = float((gl - r).abs().max()) / max(1.0, float(r.abs().max()))
            worst = max(worst, err)
            if not err <= 1e-3:
                raise SystemExit(f"small reference: {field}[{l}] off by {err:.3e}")
    log(f"check small UQ card vs cpu {size} {cfg.df_resolution} N={n}: worst scaled err "
        f"{worst:.3e} (tol 1e-3) ok")


def check_small_train(dev, size=(32, 40, 48)):
    """One training step's forward and backward on the card (kernels)
    against the CPU (plain versions): same weights, batch (B = 2) and
    draws, float32. Losses within 1e-3 relative; each gradient within
    1e-3 of its leaf's scale (of 1 % of the largest gradient for the
    conv biases that feed a train BatchNorm: their gradient is 0 in
    exact arithmetic, so both sides hold rounding noise); the new
    BatchNorm statistics within 1e-5."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    cfg = PULPoConfig(input_size=size, total_levels=3, latent_levels=2, n0=8, batch_size=2)
    ref_model = PULPoModel(cfg, device="cpu")
    ref_model.init(6)
    model = PULPoModel(cfg, device=dev)
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(3)
    batch = {k: rng.random((2, *size, 1), dtype=np.float32) for k in ("x", "y")}
    noise = {l: torch.from_numpy(rng.standard_normal((2, *cfg.level_sizes[l], cfg.zdim),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    ref_g, ref_s, ref_m = compute_grads(ref_model, batch, noise=noise)
    got_g, got_s, got_m = compute_grads(model, batch, noise=noise)
    worst_loss = 0.0
    for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
        r, gv = float(ref_m[k]), float(got_m[k])
        err = abs(gv - r) / max(abs(r), 1e-6)
        worst_loss = max(worst_loss, err)
        if not err <= 1e-3:
            raise SystemExit(f"small train step: {k} {gv} vs cpu {r}")
    top = max(float(v.abs().max()) for v in ref_g.values())
    worst = 0.0
    for n, r in ref_g.items():
        err = float((got_g[n].cpu() - r).abs().max()) / max(float(r.abs().max()), 1e-2 * top)
        worst = max(worst, err)
        if not err <= 1e-3:
            raise SystemExit(f"small train step: gradient {n} off by {err:.3e} of its scale")
    for n, r in ref_s.items():
        if not float((got_s[n].cpu() - r).abs().max()) <= 1e-5:
            raise SystemExit(f"small train step: BatchNorm statistic {n} differs")
    log(f"check small train step card vs cpu {size} B=2: losses rel err {worst_loss:.3e}, "
        f"gradients worst scaled err {worst:.3e} (tol 1e-3), statistics ok")


# ----------------------------------------------------------------------
# phase 5: the main path
# ----------------------------------------------------------------------

def serving_launches(cfg, decodes, requests):
    """Launches of a UQ request stream: `decodes` decodes (the chunks
    and the one-sample calibration decode) and `requests` mean-SVF tails
    and encodes. Per decode: a head per level, a posterior head per
    non-coarsest level, one integration per level and the image warp
    (one per level, or one batched launch for all levels on the
    channels-first path); per tail: one integration per level and the
    image warp. No backward, no loss, no narrow conv. In 2D the fused
    eval kernels take nothing (the library convs run): the 2D squaring
    and warp only."""
    from pulpo_tpu_torch.models.pulpo import cf_fields

    K, nsteps = cfg.latent_levels, cfg.nsteps
    integrations = nsteps * K * (decodes + requests)
    if cfg.ndims == 2:
        return {"squaring_2d": integrations, "warp_2d": K * (decodes + requests)}
    cf = cf_fields(cfg)
    return {
        "warp": 0 if cf else K * (decodes + requests),
        "squaring": 0 if cf else integrations,
        "squaring_cf": integrations if cf else 0,
        "warp_cf": decodes + requests if cf else 0,
        "vel_head": K * decodes,
        "warp_dfgrad": 0, "warp_mgrad": 0, "squaring_bwd": 0, "box_sum": 0,
        "conv_narrow": 0,
        **eval_launches(cfg, requests, decodes),
    }


def run_main_path(dev, cfg_kw, n_samples, n_requests, name="serving path"):
    """`n_requests` UQ requests of `n_samples` on the configuration
    `cfg_kw` (random weights from seed 0, one synthetic pair each): every
    leaf finite, exact launch counts; returns the counts and the request
    times, peaks and chunk."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(**cfg_kw)
    t0 = time.perf_counter()
    model = PULPoModel(cfg, device=dev)
    model.init(seed=0)
    ds = SyntheticDataset(shape=cfg.input_size, n=n_requests + 1, seed=0)
    pairs = [ds.get_pair(i, np.random.default_rng(i)) for i in range(n_requests)]
    log(f"{name}: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.df_resolution} feedback {list(cfg.feedback)}, "
        f"{model.param_count} params, set-up {time.perf_counter() - t0:.1f} s")

    decodes = 0
    chunks, times, peaks = [], [], []
    reset_counts()
    for i, pair in enumerate(pairs):
        x, y = pair["x"][None], pair["y"][None]
        calibrated = len(model.decode_bytes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = predict_with_uncertainty(model, x, y, n_samples, seed=i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        chunk = res.outputs[0].shape[1]
        chunks.append(chunk)
        times.append(dt)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        decodes += n_samples // chunk + (len(model.decode_bytes) - calibrated)
        for field, d in res._asdict().items():
            if d is None:
                continue
            for l, v in d.items():
                if not bool(torch.isfinite(v).all()):
                    raise SystemExit(f"{name} request {i}: {field}[{l}] not finite")
        log(f"{name} request {i}: {dt:.3f} s  chunk {chunk}  "
            f"max_memory_allocated {peaks[-1]:.2f} GiB  "
            f"decode bytes/sample {max(model.decode_bytes.values(), default=0) / 2**30:.2f} GiB  "
            "all leaves finite")
    counts = read_counts()
    expect(counts, serving_launches(cfg, decodes, n_requests), f"{name} ({decodes} decodes)")
    return counts, {"chunk": max(chunks), "times": times, "peaks": peaks}


# ----------------------------------------------------------------------
# phase 5b: the training path
# ----------------------------------------------------------------------

def train_launches(cfg, steps, val_forwards=0):
    """Launches of `steps` 2D training steps and `val_forwards` eval
    forwards with their losses. Per step and level: one integration
    (nsteps 2D squaring launches; its backward replays the plain version,
    as the JAX package's 2D backward is XLA's VJP), one image warp (its
    cotangents likewise), the NCC's 5 box sums forward and 3 backward;
    per eval forward and level: the integration, the warp and 5 box
    sums. The fused eval kernels and the narrow conv are 3D only."""
    assert cfg.ndims == 2
    K, nsteps = cfg.latent_levels, cfg.nsteps
    forwards = steps + val_forwards
    return {"squaring_2d": nsteps * K * forwards, "warp_2d": K * forwards,
            "box_sum_2d": (5 + 3) * K * steps + 5 * K * val_forwards}


def run_train_path(dev, cfg_kw, steps):
    """The flagship training step: 1 warm-up and `steps` timed steps of
    `make_train_step` on one synthetic pair (B = 1)."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train import create_train_state, make_train_step

    cfg = PULPoConfig(**cfg_kw, batch_size=1)
    model = PULPoModel(cfg, device=dev)
    state, tx = create_train_state(model, seed=0)
    step = make_train_step(model, tx)
    pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=1).get_pair(
        0, np.random.default_rng(1))
    batch = {k: torch.as_tensor(pair[k][None]).to(dev) for k in ("x", "y")}
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    log(f"training path: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.df_resolution} {cfg.recon_loss} "
        f"{cfg.regularizer} lr {cfg.lr} B 1")

    K = cfg.latent_levels
    times = []
    reset_counts()
    for i in range(1 + steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        losses = {k: float(metrics[k]) for k in
                  ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss")}
        if not all(math.isfinite(v) for v in losses.values()) or state.nan_flag:
            raise SystemExit(f"train step {i}: losses {losses}, nan_flag {state.nan_flag}")
        if i:
            times.append(dt)
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: {dt:.3f} s  "
            + "  ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    counts = read_counts()
    n = 1 + steps
    expected = train_launches(cfg, n) if cfg.ndims == 2 else {
        # per step and level: one integration forward (nsteps launches)
        # and backward (nsteps), one image warp and its df-cotangent (the
        # moving image needs no gradient, so no moving-cotangent), the
        # NCC's 5 box sums forward and 3 backward (of j, j^2 and ij; the
        # target's sums need none); the velocity head runs its plain
        # chain in train mode, its first conv and down_block_0's on the
        # narrow-conv kernel
        "warp": K * n, "squaring": cfg.nsteps * K * n, "vel_head": 0,
        "warp_dfgrad": K * n, "warp_mgrad": 0, "squaring_bwd": cfg.nsteps * K * n,
        "box_sum": (5 + 3) * K * n, "pos_head": 0, "conv_chain": 0,
        "squaring_cf": 0, "warp_cf": 0, "conv_narrow": train_narrow_launches(cfg) * n,
    }
    expect(counts, expected, f"training path ({n} steps)")
    changed = sum(not torch.equal(p.detach(), before[n])
                  for n, p in model.module.named_parameters())
    if changed == 0:
        raise SystemExit("training path: no parameter changed")
    peak = torch.cuda.max_memory_allocated()
    mean = sum(times) / len(times)
    log(f"training path: step {mean:.3f} s mean of {steps} ({' '.join(f'{t:.3f}' for t in times)}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, {changed} of {len(before)} "
        f"parameter tensors changed, {model.param_count} params")
    return counts, {"step_s": mean, "peak_gib": peak / 2**30}


# ----------------------------------------------------------------------
# phase 5c: the serve entry
# ----------------------------------------------------------------------

def run_serve_path(dev, cfg_kw, n_samples, chunk, n_uq, tmpdir):
    """The model of `cfg_kw` (the flagship, or `flagship-2d` in phase 7c)
    exported to an artifact and served from it: each entry's time, its
    outputs against the live model's bit for bit, and the launch
    counts."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.serve import ServedModel, export_model
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(**cfg_kw)
    model = PULPoModel(cfg, device=dev)
    model.init(seed=0)
    path = pathlib.Path(tmpdir) / "flagship.pulpo"
    t = time.perf_counter()
    export_model(model, str(path), batch_size=1, N=n_samples, chunk=chunk)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    served = ServedModel(str(path), device=dev)
    load_s = time.perf_counter() - t
    pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=5).get_pair(
        0, np.random.default_rng(5))
    x, y = (torch.as_tensor(pair[k][None]).to(dev) for k in ("x", "y"))
    log(f"serve path: artifact {path.stat().st_size} bytes, kernels "
        f"{sorted(served.manifest['kernels'])}, export {export_s:.2f} s, load {load_s:.2f} s")

    def timed(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    reset_counts()
    det, det_s = timed(served.predict_deterministic, x, y)
    mean, mean_s = timed(served.predict_mean, x, y, 11)
    uqs, uq_s = [], []
    for i in range(n_uq):
        out, dt = timed(served.uq, x, y, 11)
        uqs.append(out)
        uq_s.append(dt)
    counts = read_counts()
    K = cfg.latent_levels
    decodes = 1 + (1 + n_uq) * (n_samples // chunk)
    tails = 1 + n_uq  # each UQ entry's mean-SVF integration and warp per level
    expect(counts, serving_launches(cfg, decodes, tails) if cfg.ndims == 2 else {
        "warp": K * (decodes + tails), "squaring": cfg.nsteps * K * (decodes + tails),
        "vel_head": K * decodes, "warp_dfgrad": 0, "warp_mgrad": 0, "squaring_bwd": 0,
        "box_sum": 0, "squaring_cf": 0, "warp_cf": 0, "conv_narrow": 0,
        **eval_launches(cfg, 2 + n_uq, decodes),
    }, f"serve path ({decodes} decodes)")
    log(f"serve path: predict_deterministic {det_s:.3f} s, predict_mean (N={n_samples}) "
        f"{mean_s:.3f} s, uq (N={n_samples}) {' '.join(f'{t:.3f}' for t in uq_s)} s")

    live = model.apply_eval(x, y, deterministic=True)
    res = predict_with_uncertainty(model, x, y, n_samples, seed=11, chunk=chunk)
    want = {"predict_deterministic": (live[7][0], live[6][0]),
            "predict_mean": (res.mean_outputs[0], res.final_dfs[0]),
            "uq": (res.mean_outputs[0], res.final_dfs[0], res.output_std[0],
                   res.output_entropy[0])}
    for name, got in [("predict_deterministic", det), ("predict_mean", mean)] + [
            ("uq", u) for u in uqs]:
        for i, (a, b) in enumerate(zip(got, want[name])):
            if not (bool(torch.isfinite(a).all()) and torch.equal(a, b)):
                raise SystemExit(f"serve path: {name} output {i} differs from the live model "
                                 f"(max abs {float((a.float() - b.float()).abs().max()):.3e})")
    log("serve path: every served output equals the live model's bit for bit, all finite")
    return counts, {"bytes": path.stat().st_size, "det_s": det_s, "mean_s": mean_s,
                    "uq_s": uq_s}


# ----------------------------------------------------------------------
# phase 7: the LungCT path
# ----------------------------------------------------------------------

class RespiratoryPairs:
    """An in-memory LungCT split with `LungCT.get_pair`'s schema (the card's
    machine has no h5py): `n` inhale volumes (moving) made from a seed
    with numpy, smooth noise upsampled to `size`, and their exhale
    volumes (fixed), the inhale warped on the CPU by the plain warp under
    `respiratory_field`. With `lms`, 8 landmarks per pair: drawn in the
    exhale, and moved by the same field into the inhale."""

    def __init__(self, size, n, seed, lms=False):
        import numpy as np
        import torch
        import torch.nn.functional as F

        from pulpo_tpu_torch.kernels.warp import warp_plain

        rng = np.random.default_rng(seed)
        self.input_size = tuple(size)
        self.lms = lms
        df = respiratory_field(size, SI_RAMP, DRIFT, "cpu")
        self.pairs = []
        for _ in range(n):
            coarse = torch.from_numpy(rng.random([s // 8 for s in size], dtype=np.float32))
            vol = F.interpolate(coarse[None, None], size=tuple(size), mode="trilinear",
                                align_corners=True)[0, 0]
            vol = (vol - vol.min()) / (vol.max() - vol.min())
            exhale = warp_plain(vol[None, ..., None], df)[0, ..., 0]
            lm_y = rng.uniform(8, np.asarray(size) - 8, (LUNGCT_LANDMARKS, 3)).astype(np.float32)
            lm_x = lm_y + respiratory_displacement(torch.from_numpy(lm_y), size, SI_RAMP,
                                                   DRIFT).numpy()
            self.pairs.append((vol.numpy(), exhale.numpy(), lm_x, lm_y))

    def __len__(self):
        return len(self.pairs)

    def get_pair(self, index, rng):
        inhale, exhale, lm_x, lm_y = self.pairs[index]
        return {"x": inhale[..., None], "y": exhale[..., None], "seg_x": None, "seg_y": None,
                "lm_x": lm_x if self.lms else None, "lm_y": lm_y if self.lms else None,
                "mask_x": None, "mask_y": None}


def payload_difference(a, b):
    """The first difference between two checkpoint payloads
    (train/checkpoint.py:state_payload), bit for bit, or None."""
    import torch

    for k in ("step", "nan_flag"):
        if a[k] != b[k]:
            return f"{k} {a[k]} != {b[k]}"
    if a["adam"]["count"] != b["adam"]["count"] or not torch.equal(a["rng"], b["rng"]):
        return "Adam count or generator state"
    for group, da, db in (("model", a["model"], b["model"]),
                          ("adam.mu", a["adam"]["mu"], b["adam"]["mu"]),
                          ("adam.nu", a["adam"]["nu"], b["adam"]["nu"])):
        if sorted(da) != sorted(db):
            return f"{group} keys"
        for k in da:
            if not torch.equal(da[k].cpu(), db[k].cpu()):
                return f"{group} {k}"
    return None


def equal_payloads(a, b, what):
    diff = payload_difference(a, b)
    if diff is not None:
        raise SystemExit(f"{what}: {diff} differs")


def check_table(table, may_be_nan, what):
    """Every entry finite, but where `may_be_nan(set, metric, row)` allows
    the zero-scrub's (or an absent modality's) NaN."""
    import numpy as np

    for c, (set_, metric) in enumerate(table.columns):
        for r, v in enumerate(table.values[:, c]):
            if np.isnan(v) and may_be_nan(set_, metric, r):
                continue
            if not np.isfinite(v):
                raise SystemExit(f"{what}: ({set_}, {metric}) row {r} is {v}")


def expect(counts, expected, what):
    """Every kernel's count equals `expected`'s; a kernel it leaves out
    must not have launched."""
    log(f"{what} launches {counts} expected {expected} (0 for the others)")
    for k in counts:
        if counts[k] != expected.get(k, 0):
            raise SystemExit(f"{what}: launch count of {k}: {counts[k]}, "
                             f"expected {expected.get(k, 0)}")


def run_lungct_path(dev, cfg_kw, steps, n_samples, run_root):
    """The Trainer, the checkpoints and the evaluation tables on the
    full-width LungCT configuration."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.lungct import split_loaders
    from pulpo_tpu_torch.eval import evaluator
    from pulpo_tpu_torch.train.checkpoint import read_checkpoint
    from pulpo_tpu_torch.train.loop import Trainer
    from pulpo_tpu_torch.train.metrics import read_metrics

    cfg = PULPoConfig(**cfg_kw, batch_size=1, max_epochs=steps, log_every_n_steps=2)
    K, nsteps = cfg.latent_levels, cfg.nsteps
    t = time.perf_counter()
    splits = [RespiratoryPairs(cfg.input_size, LUNGCT_PAIRS, seed=40 + i, lms=(i == 2))
              for i in range(3)]
    log(f"lungct path: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.df_resolution}, {LUNGCT_PAIRS} pairs per "
        f"split, {LUNGCT_LANDMARKS} test landmarks, data {time.perf_counter() - t:.1f} s")

    # training: the Trainer validates, keeps the best checkpoints and
    # `latest`, and logs after every step (len(train) * 0.1 < 1)
    train_loader, val_loader, _ = split_loaders(*splits, cfg.batch_size, cfg.random_seed)
    trainer = Trainer(cfg, run_dir=run_root, experiment="lungct", device=dev)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = trainer.fit(train_loader, val_loader, max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    trainer.close()
    run_dir = trainer.run_dir
    train_counts = read_counts()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    times = trainer.times
    n_steps, n_val = len(times["step"]), len(times["validate"]) * len(val_loader.dataset)
    if n_steps != steps or state.nan_flag:
        raise SystemExit(f"lungct training: {n_steps} steps, nan_flag {state.nan_flag}")
    expect(train_counts, {
        # per step as the training path; per validation pair one eval
        # forward (a decode with the head kernel) and its 5 NCC box sums
        # per level, no backward
        "warp": K * (n_steps + n_val), "squaring": nsteps * K * (n_steps + n_val),
        "vel_head": K * n_val, "warp_dfgrad": K * n_steps, "warp_mgrad": 0,
        "squaring_bwd": nsteps * K * n_steps, "box_sum": 8 * K * n_steps + 5 * K * n_val,
        "squaring_cf": 0, "warp_cf": 0, "conv_narrow": train_narrow_launches(cfg) * n_steps,
        **eval_launches(cfg, n_val, n_val),
    }, "lungct training")
    rows = read_metrics(run_dir)
    tags = set().union(*rows)
    for tag in ("train/total_loss", "train_levels/kl/0", "train_distribution_levels/"
                "mean_posterior_mu/0", "val/total_loss", "val/reconstruction_loss"):
        if tag not in tags:
            raise SystemExit(f"metrics.jsonl has no {tag}")
    for row in rows:
        bad = [k for k, v in row.items() if not (isinstance(v, (int, float)) and math.isfinite(v))]
        if bad:
            raise SystemExit(f"metrics.jsonl step {row['step']}: not finite {bad}")
    last = {k: v for k, v in rows[-1].items() if k.startswith("val/")}
    with_io = [a + b + c for a, b, c in zip(times["step"], times["validate"], times["checkpoint"])]
    ck = trainer.ckpt.last_save
    log(f"lungct training: {n_steps} steps in {fit_s:.2f} s; step "
        f"{' '.join(f'{x:.3f}' for x in times['step'])} s; with validation and checkpoints "
        f"{' '.join(f'{x:.3f}' for x in with_io)} s; validation "
        f"{' '.join(f'{x:.3f}' for x in times['validate'])} s; checkpoint rounds "
        f"{' '.join(f'{x:.3f}' for x in times['checkpoint'])} s")
    log(f"lungct training: checkpoint {ck['bytes']} bytes written in {ck['seconds']:.3f} s; "
        f"max_memory_allocated {train_peak:.2f} GiB; last validation {last}")

    # the checkpoint round trip on the card
    check_reload(run_dir, state, cfg, dev, "lungct")
    del trainer, state
    torch.cuda.empty_cache()

    # evaluation: the tables on the reloaded run, landmarks on the test split
    ev = evaluator.Evaluate(device=dev)
    ev.load_model(run_dir)
    stored = read_checkpoint(run_dir, ev.loaded_checkpoint)["model"]
    for k, v in ev.model.state_dict().items():
        if not torch.equal(v.cpu(), stored[k]):
            raise SystemExit(f"reloaded {k} differs from {ev.loaded_checkpoint}")
    ev.set_data(split_loaders(*splits, 1), ["train", "val", "test"], segs=False, lms=True,
                mask=False)
    pairs = sum(len(dl.dataset) for dl in ev.loaders)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    perf = ev.performance()
    torch.cuda.synchronize()
    perf_s = time.perf_counter() - t
    with RecordedRequests(n_samples) as rec:
        t = time.perf_counter()
        unc = ev.uncertainty(num_samples=n_samples)
        torch.cuda.synchronize()
        unc_s = time.perf_counter() - t
    eval_counts = read_counts()
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    decodes, chunks = rec.decodes, rec.chunks
    expect(eval_counts, {
        # performance: per pair one deterministic decode and the K
        # integrations of combine_dfs; uncertainty: as the serving path
        "warp": K * pairs + K * (decodes + pairs),
        "squaring": 2 * nsteps * K * pairs + nsteps * K * (decodes + pairs),
        "vel_head": K * pairs + K * decodes,
        "warp_dfgrad": 0, "warp_mgrad": 0, "squaring_bwd": 0, "box_sum": 0,
        "squaring_cf": 0, "warp_cf": 0, "conv_narrow": 0,
        # performance: one encode per pair; uncertainty: one per request
        **eval_launches(cfg, 2 * pairs, pairs + decodes),
    }, f"lungct evaluation ({decodes} decodes, chunks {chunks})")
    lm_cols = ("LM_MAE", "LM_Euclid", "LM_VAR", "LM_NCC")
    check_table(perf, lambda s, m, r: m == "JDetLeq0" or (m in lm_cols and (s != "test" or r > 0)),
                "performance table")
    check_table(unc, lambda s, m, r: m in lm_cols and s != "test", "uncertainty table")
    for table, need in ((perf, ("LM_MAE", "LM_Euclid")), (unc, ("LM_VAR", "LM_NCC"))):
        for m in need:
            if ("test", m) not in table or not np.isfinite(table[("test", m)][0]):
                raise SystemExit(f"no finite (test, {m}) in the tables")
    log(f"lungct evaluation: performance table {perf_s:.3f} s, uncertainty table (N={n_samples}) "
        f"{unc_s:.3f} s, max_memory_allocated {eval_peak:.2f} GiB, checkpoint "
        f"{ev.loaded_checkpoint}")
    log("performance table (deterministic):\n" + str(perf))
    log("uncertainty table:\n" + str(unc))
    info = {"step_s": sum(times["step"][1:]) / max(1, n_steps - 1),
            "step_with_io_s": sum(with_io[1:]) / max(1, n_steps - 1),
            "ckpt_bytes": ck["bytes"], "ckpt_s": ck["seconds"], "train_peak_gib": train_peak,
            "eval_peak_gib": eval_peak, "perf_s": perf_s, "unc_s": unc_s}
    return train_counts, eval_counts, info


# ----------------------------------------------------------------------
# phase 7b: train_cli on the 2D configuration
# ----------------------------------------------------------------------

def run_train_cli_2d(dev, steps, run_root):
    """`train_cli --ndims 2 --dataset synthetic` (its 64x64 default, the
    CLI's default network) for `steps` steps on the card: finite
    validation losses after every step, exact launch counts, and a
    `latest` checkpoint that reloads into a fresh state bit for bit."""
    import torch

    from pulpo_tpu_torch import train_cli
    from pulpo_tpu_torch.train.checkpoint import CheckpointManager
    from pulpo_tpu_torch.train.metrics import read_metrics

    accelerator = "gpu" if dev.type == "cuda" else "cpu"
    reset_counts()
    t = time.perf_counter()
    run_dir = train_cli.main(["--ndims", "2", "--dataset", "synthetic", "--max_steps",
                              str(steps), "--skip_eval", "--run_dir", str(run_root),
                              "--accelerator", accelerator])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = read_counts()
    cfg = CheckpointManager.load_config(run_dir)
    rows = read_metrics(run_dir)
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise SystemExit(f"train_cli 2D: validation rows {[r['step'] for r in rows]}")
    for r in rows:
        for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
            if not math.isfinite(r[f"val/{k}"]):
                raise SystemExit(f"train_cli 2D: step {r['step']} val/{k} {r[f'val/{k}']}")
    # validation after every step (8 pairs x 0.1 < 1), over the 8 pairs
    expect(counts, train_launches(cfg, steps, val_forwards=8 * steps),
           f"train_cli 2D ({steps} steps)")
    saved = check_reload(run_dir, None, cfg, dev, "train_cli 2D")
    if saved["step"] != steps:
        raise SystemExit(f"train_cli 2D: latest checkpoint at step {saved['step']}")
    log(f"train_cli 2D: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype}, {steps} steps with validation in {fit_s:.3f} s, "
        f"val total_loss {' '.join(str(r['val/total_loss']) for r in rows)}, checkpoint "
        "reloads bit for bit")
    return counts


# ----------------------------------------------------------------------
# phase 3g: the segmentation shapes (C = 36 one-hot channels)
# ----------------------------------------------------------------------

def seg_shapes(cfg, rows=1):
    """The (moving, df) shapes of `transform_segmentation`'s warps on a
    level_res configuration: level 0 the full-size one-hot map under the
    level-0 df (at the input size), level l > 0 the ceil-mode pooled map
    under that level's df."""
    size = tuple(cfg.input_size)
    pooled = lambda s: tuple(-(-n // 2) for n in s)
    for _ in range(cfg.lk_offset):
        size = pooled(size)
    shapes = [((rows, *cfg.input_size, SEG_CLASSES), (rows, *cfg.df_size(0), cfg.ndims))]
    for l in range(1, cfg.latent_levels):
        size = pooled(size)
        shapes.append(((rows, *size, SEG_CLASSES), (rows, *cfg.df_size(l), cfg.ndims)))
    return shapes


def onehot_volume(shape, seed, dev):
    """A one-hot float32 map (rows, *size, SEG_CLASSES) of smooth labels."""
    import torch

    rows, *size, c = shape
    labels = (smooth_field(rows, size, 1.0, seed, dev, channels=1)[..., 0] * 0.5 + 0.5) * c
    return torch.nn.functional.one_hot(labels.long().clamp(0, c - 1), c).float()


def check_seg_kernels(dev, cfg, cfg_2d, checks, rows_2d=OASIS_SAMPLES):
    """Phase 3g: the warp (#4) and its df-cotangent (#6) at C = 36 at
    every shape of the flagship's segmentation warps (a smooth 3-voxel
    df), and the 2D warp at C = 36 over `rows_2d` rows at the 2D input
    size (`Evaluate.predict`'s per-sample maps). The warps are bit-equal
    to their plain versions (the same operations in the same order); the
    df-cotangent is held to 1e-5 of scale (the plain version's channel
    `sum` adds its 36 products in its own order)."""
    import torch

    from pulpo_tpu_torch.kernels import warp

    fmt = lambda s: "x".join(map(str, s))
    for l, (mshape, dshape) in enumerate(seg_shapes(cfg)):
        seg = onehot_volume(mshape, 300 + l, dev)
        df = smooth_field(dshape[0], dshape[1:-1], 3.0, seed=310 + l, device=dev)
        g = torch.randn(dshape[:-1] + (SEG_CLASSES,), generator=torch.Generator().manual_seed(
            320 + l)).to(dev)
        case = f"C={SEG_CLASSES} level {l} {fmt(mshape[1:-1])} df {fmt(dshape[1:-1])}"
        checks.record("warp", case, warp.warp(seg, df), warp.warp_plain(seg, df), 0.0)
        ref = warp.warp_dfgrad_plain(seg, df, g)
        checks.record("warp_dfgrad", case, warp.warp_dfgrad(seg, df, g), ref, scaled(ref, 1e-5))
        del seg, df, g, ref
    full = cfg_2d.input_size
    seg = onehot_volume((1, *full, SEG_CLASSES), 330, dev).repeat_interleave(rows_2d, 0)
    df = smooth_field(rows_2d, full, 3.0, seed=331, device=dev, channels=2)
    checks.record("warp_2d", f"C={SEG_CLASSES} {rows_2d} rows {fmt(full)}", warp.warp(seg, df),
                  warp.warp_plain(seg, df), 0.0)
    torch.cuda.empty_cache()


def time_seg_kernels(dev, cfg, cfg_2d, rows_2d=OASIS_SAMPLES):
    """#4 and #6 at C = 36 at each segmentation shape, and the 2D warp at
    C = 36 over `rows_2d` rows: device time by CUDA-graph replay, eager
    time, the plain version, and `F.grid_sample` (the warp) or its VJP to
    the grid (#6) on a channels-first copy of the map. Bounds: each input
    read once and each output written once over 3.35 TB/s. Returns
    {kernel: {shape: record}}."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import warp

    fmt = lambda s: "x".join(map(str, s))
    res = {"warp": {}, "warp_dfgrad": {}, "warp_2d": {}}
    cases = [(l, m, d) for l, (m, d) in enumerate(seg_shapes(cfg))]
    cases.append(("2d", (rows_2d, *cfg_2d.input_size, SEG_CLASSES),
                  (rows_2d, *cfg_2d.input_size, 2)))
    for l, mshape, dshape in cases:
        seg = onehot_volume((1, *mshape[1:]), 340, dev).repeat_interleave(mshape[0], 0)
        df = smooth_field(dshape[0], dshape[1:-1], 3.0, seed=341, device=dev,
                          channels=dshape[-1])
        n_in, n_out = math.prod(mshape[:-1]), math.prod(dshape[:-1])
        c, nd = SEG_CLASSES, dshape[-1]
        seg_cf = seg.permute(0, len(mshape) - 1, *range(1, len(mshape) - 1)).contiguous()
        grid = grid_for(df)
        key = f"level {l} {fmt(mshape[1:-1])} df {fmt(dshape[1:-1])}" if l != "2d" else \
            f"{mshape[0]} rows {fmt(mshape[1:-1])}"
        lib = graph_ms(lambda: F.grid_sample(seg_cf, grid, mode="bilinear",
                                             padding_mode="border", align_corners=False), 5)
        name = "warp" if l != "2d" else "warp_2d"
        res[name][key] = dict(
            ms=graph_ms(lambda: warp.warp(seg, df), 5), eager_ms=time_ms(
                lambda: warp.warp(seg, df), 3),
            plain_ms=time_ms(lambda: warp.warp_plain(seg, df), 1, warmup=1), library_ms=lib,
            bound_ms=(n_in * c + n_out * (nd + c)) * 4 / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
        if l != "2d":
            g = torch.randn(dshape[:-1] + (c,), device=dev)
            gr = grid.clone().requires_grad_(True)
            out = F.grid_sample(seg_cf, gr, mode="bilinear", padding_mode="border",
                                align_corners=False)
            gcf = g.permute(0, 4, 1, 2, 3).contiguous()
            res["warp_dfgrad"][key] = dict(
                ms=graph_ms(lambda: warp.warp_dfgrad(seg, df, g), 5),
                eager_ms=time_ms(lambda: warp.warp_dfgrad(seg, df, g), 3),
                plain_ms=time_ms(lambda: warp.warp_dfgrad_plain(seg, df, g), 1, warmup=1),
                library_ms=time_ms(lambda: torch.autograd.grad(out, gr, gcf, retain_graph=True),
                                   3),
                bound_ms=(n_in * c + n_out * (2 * nd + c)) * 4 / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")
            del g, gr, out, gcf
        del seg, df, seg_cf, grid
        torch.cuda.empty_cache()
    for name, shapes in res.items():
        for key, r in shapes.items():
            log(f"time {name} C={SEG_CLASSES} {key}: device {r['ms']:.4f} ms "
                f"({r['bound_ms'] / r['ms']:.2f} of its bound), eager {r['eager_ms']:.4f} ms  "
                f"plain {r['plain_ms']:.3f} ms  library {r['library_ms']:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms (bytes)")
    return res


# ----------------------------------------------------------------------
# phases 7c, 8, 8b, 8c: the OASIS and BraTS readers on in-memory stores
# ----------------------------------------------------------------------

class MemoryGroup(dict):
    """A group of an in-memory store in the readers' HDF5 layout: named
    children (groups or numpy arrays) and `attrs`."""

    def __init__(self, attrs=None, **children):
        super().__init__(children)
        self.attrs = dict(attrs or {})

    def __enter__(self):  # `with h5py.File(path) as f:`
        return self

    def __exit__(self, *exc):
        return False


class memory_stores:
    """Serve `stores` ({path: MemoryGroup}) to the readers as the `h5py`
    module would serve files: the card's machine has no h5py, so while
    this context is open `import h5py` finds a stand-in whose
    `File(path, mode)` returns the registered store. The readers then run
    as they are (`__init__`, `get_pair`, `create_data_loaders`), also
    under `train_cli` and `Evaluate.load_data`."""

    def __init__(self, stores):
        import types

        self.module = types.ModuleType("h5py")
        self.module.File = lambda path, mode="r": stores[str(path)]

    def __enter__(self):
        self.before = sys.modules.get("h5py")
        sys.modules["h5py"] = self.module
        return self

    def __exit__(self, *exc):
        if self.before is None:
            del sys.modules["h5py"]
        else:
            sys.modules["h5py"] = self.before


def smooth_volume(size, rng):
    """A volume (or slice) in [0, 1]: coarse uniform noise from `rng`,
    upsampled (tri/bi)linearly to `size`, float32 numpy."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    coarse = torch.from_numpy(rng.random([max(2, s // 8) for s in size], dtype=np.float32))
    mode = "trilinear" if len(size) == 3 else "bilinear"
    vol = F.interpolate(coarse[None, None], size=tuple(size), mode=mode, align_corners=True)[0, 0]
    return ((vol - vol.min()) / (vol.max() - vol.min())).numpy()


def oasis_store(size, splits, seed, landmarks=OASIS_LANDMARKS):
    """An OASIS store (pulpo_tpu_torch/data/oasis.py's layout) made from a
    seed: per split `image/<i>` smooth volumes, `seg/<i>` int16 label maps
    of SEG_CLASSES classes (the volume's intensity bands), `landmarks/<i>`
    on test_lm."""
    import numpy as np

    rng = np.random.default_rng(seed)
    root = MemoryGroup({"shape": np.asarray(size)})
    for split, n in zip(("training", "validation", "test_seg", "test_lm"), splits):
        image, seg, lms = MemoryGroup(), MemoryGroup(), MemoryGroup()
        for i in range(n):
            vol = smooth_volume(size, rng)
            image[str(i)] = vol
            seg[str(i)] = np.minimum(vol * SEG_CLASSES, SEG_CLASSES - 1).astype(np.int16)
            if split == "test_lm":
                lms[str(i)] = rng.uniform(8, np.asarray(size) - 8,
                                          (landmarks, len(size))).astype(np.float32)
        root[split] = MemoryGroup({"N": n, "seg_dim": SEG_CLASSES}, image=image, seg=seg,
                                  landmarks=lms)
    return root


def brats_store(size, splits, seed):
    """A BraTS store (pulpo_tpu_torch/data/brats.py's layout) from a seed:
    per split and case a baseline t1ce volume and its follow-up (the
    baseline plus a smooth change)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    root = MemoryGroup({"shape": np.asarray(size)})
    for split, n in zip(("training", "validation", "test"), splits):
        base, follow = MemoryGroup(), MemoryGroup()
        for i in range(n):
            base[str(i)] = smooth_volume(size, rng)
            follow[str(i)] = (0.8 * base[str(i)] + 0.2 * smooth_volume(size, rng)).astype(
                np.float32)
        root[split] = MemoryGroup({"N": n}, base=MemoryGroup(t1ce=base),
                                  follow=MemoryGroup(t1ce=follow))
    return root


class RecordedRequests:
    """Wraps `evaluator.predict_with_uncertainty` while open: notes each
    request's decodes (its chunks and any calibration decode), for the
    launch counts."""

    def __init__(self, n_samples):
        self.n_samples = n_samples
        self.decodes = 0
        self.chunks = []
        self.per_request = []

    def __enter__(self):
        from pulpo_tpu_torch.eval import evaluator

        self.uq = uq = evaluator.predict_with_uncertainty

        def recorded(model, *args, **kw):
            calibrated = len(model.decode_bytes)
            res = uq(model, *args, **kw)
            chunk = res.outputs[0].shape[1]
            self.chunks.append(chunk)
            self.per_request.append(self.n_samples // chunk + len(model.decode_bytes)
                                    - calibrated)
            self.decodes += self.per_request[-1]
            return res

        evaluator.predict_with_uncertainty = recorded
        return self

    def __exit__(self, *exc):
        from pulpo_tpu_torch.eval import evaluator

        evaluator.predict_with_uncertainty = self.uq


def step_launches(cfg, steps, val_forwards=0, dice=False):
    """Launches of `steps` 3D training steps and `val_forwards` eval
    forwards with their losses (phase 7's accounting). Per step and
    level: one integration forward and backward (nsteps each), the image
    warp and its df-cotangent, the NCC's 5 box sums forward and 3
    backward; per eval forward and level: the integration, the warp, 5
    box sums, a velocity head, and its encode's and decode's conv chains.
    With a Dice loss each forward also warps the level's one-hot map (and
    a step takes its df-cotangent: the map needs no gradient). At
    full_res without "transformed" feedback a forward warps its image (and
    map) by all levels' dfs in one launch."""
    from pulpo_tpu_torch.models.pulpo import batch_warp

    K, nsteps = cfg.latent_levels, cfg.nsteps
    maps = (2 if dice else 1) * (1 if batch_warp(cfg) else K)
    return {
        "warp": maps * (steps + val_forwards),
        "squaring": nsteps * K * (steps + val_forwards), "vel_head": K * val_forwards,
        "warp_dfgrad": maps * steps, "warp_mgrad": 0, "squaring_bwd": nsteps * K * steps,
        "box_sum": 8 * K * steps + 5 * K * val_forwards, "squaring_cf": 0, "warp_cf": 0,
        "conv_narrow": train_narrow_launches(cfg) * steps,
        **eval_launches(cfg, val_forwards, val_forwards),
    }


def decode_launches(cfg, decodes, encodes):
    """Launches of `decodes` eval decodes and `encodes` encodes: per decode
    and level the velocity head, the integration and the image warp, and
    the posterior heads and conv chains of `eval_launches`. In 2D the
    squaring and warp run their 2D kernels and the fused kernels none."""
    K, nsteps = cfg.latent_levels, cfg.nsteps
    if cfg.ndims == 2:
        return {"warp_2d": K * decodes, "squaring_2d": nsteps * K * decodes}
    return {"warp": K * decodes, "squaring": nsteps * K * decodes, "vel_head": K * decodes,
            **eval_launches(cfg, encodes, decodes)}


def add_counts(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def table_launches(cfg, pairs, seg_pairs, decodes):
    """Launches of the performance and uncertainty tables over `pairs`
    pairs, `seg_pairs` of them with segmentations (phase 7's accounting):
    per pair one deterministic decode (`decode_launches`) and the K
    integrations of combine_dfs, per segmentation pair K one-hot warps
    (one per level's final df), and the uncertainty requests as the
    serving path (`decodes` decodes, one mean-SVF tail a pair: K warps
    and K integrations); an encode per pair for each table."""
    K, nsteps = cfg.latent_levels, cfg.nsteps
    sq, wp = ("squaring_2d", "warp_2d") if cfg.ndims == 2 else ("squaring", "warp")
    return add_counts(decode_launches(cfg, pairs + decodes, 2 * pairs),
                      {sq: 2 * nsteps * K * pairs, wp: K * (pairs + seg_pairs)})


def remat_launches(cfg, steps):
    """The extra launches of `steps` remat steps over plain ones: each
    kernel of a checkpointed region launches once more in the backward.
    `remat_down` blocks: their narrow convs; `remat`: every down block's,
    and each level's decoder (its velocity head's first conv on the
    narrow-conv kernel, the integration and the image warp; the one-hot
    warps run outside the decoders)."""
    from pulpo_tpu_torch.kernels import conv_narrow

    K = cfg.latent_levels
    cins = [2] + [cfg.num_channels[k] for k in range(cfg.total_levels - 1)]
    blocks = range(cfg.total_levels) if cfg.remat else cfg.remat_down
    narrow = sum(cins[k] <= conv_narrow.MAX_CIN for k in blocks)
    extra = {"conv_narrow": narrow * steps}
    if cfg.remat:
        heads = K if (cfg.cp_depth >= 2 and cfg.zdim <= conv_narrow.MAX_CIN) else 0
        extra = {"conv_narrow": (narrow + heads) * steps, "warp": K * steps,
                 "squaring": cfg.nsteps * K * steps}
    return extra


def check_reload(run_dir, state, cfg, dev, what):
    """`latest` equals the trained state, and a fresh state loads it bit
    for bit."""
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train import create_train_state
    from pulpo_tpu_torch.train.checkpoint import load_payload, read_checkpoint, state_payload

    saved = read_checkpoint(run_dir, "latest")
    if state is not None:
        equal_payloads(state_payload(state), saved, f"{what}: latest vs the trained state")
    fresh, _ = create_train_state(PULPoModel(cfg, device=dev), seed=1)
    load_payload(fresh, saved)
    equal_payloads(state_payload(fresh), saved, f"{what}: restored vs latest")
    return saved


def run_oasis_path(dev, cfg_kw, steps, n_samples, run_root):
    """Phase 8: the flagship's own OASIS path with segmentations. The
    port's OASIS reader on an in-memory store (`memory_stores`) feeds the
    Trainer (B = 1, NCC + Dice, validation and checkpoints); `Evaluate.
    run_one_model(task="oasis")` then writes the performance table (Dice
    on train, val and test_seg, the landmark columns on test_lm) and the
    N = 10 uncertainty table. Then 4 steps with and 4 without
    segmentations (NCC only), neither validating, and the reader alone,
    for the loader's share of a Trainer iteration."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data import oasis
    from pulpo_tpu_torch.data.loader import prefetch_to_device
    from pulpo_tpu_torch.eval.evaluator import Evaluate
    from pulpo_tpu_torch.train.loop import Trainer
    from pulpo_tpu_torch.train.metrics import read_metrics

    cfg = PULPoConfig(**cfg_kw, batch_size=1, max_epochs=steps, log_every_n_steps=2,
                      val_check_interval=0.5, image_logging_frequency=1)
    t = time.perf_counter()
    key = "memory://OASIS.h5"
    stores = {key: oasis_store(cfg.input_size, OASIS_SPLITS, seed=80)}
    pairs, seg_pairs = sum(OASIS_SPLITS), sum(OASIS_SPLITS[:3])
    log(f"oasis path: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} n0 "
        f"{cfg.n0} {cfg.compute_dtype} {cfg.df_resolution} {cfg.recon_loss} dice_factor "
        f"{cfg.dice_factor}, {SEG_CLASSES} one-hot classes, splits {OASIS_SPLITS}, store "
        f"{time.perf_counter() - t:.1f} s")
    K = cfg.latent_levels
    with memory_stores(stores):
        train_loader, val_loader, _, _ = oasis.create_data_loaders(
            1, segs=True, lms=False, path=key, seed=cfg.random_seed)
        trainer = Trainer(cfg, run_dir=run_root, experiment="oasis", device=dev)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = trainer.fit(train_loader, val_loader, max_steps=steps)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        trainer.close()
        train_counts = read_counts()
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        times = trainer.times
        n_val = len(times["validate"]) * len(val_loader.dataset)
        if len(times["step"]) != steps or state.nan_flag:
            raise SystemExit(f"oasis training: {len(times['step'])} steps, nan_flag "
                             f"{state.nan_flag}")
        expect(train_counts, step_launches(cfg, steps, n_val, dice=True),
               f"oasis training ({steps} steps, {n_val} validation forwards)")
        rows = read_metrics(trainer.run_dir)
        for row in rows:
            bad = [k for k, v in row.items()
                   if not (isinstance(v, (int, float)) and math.isfinite(v))]
            if bad:
                raise SystemExit(f"oasis metrics.jsonl step {row['step']}: not finite {bad}")
        if not any("val/reconstruction_loss" in r for r in rows):
            raise SystemExit("oasis metrics.jsonl has no validation losses")
        check_reload(trainer.run_dir, state, cfg, dev, "oasis")
        log(f"oasis training: step {' '.join(f'{x:.3f}' for x in times['step'])} s, validation "
            f"{' '.join(f'{x:.3f}' for x in times['validate'])} s, checkpoint rounds "
            f"{' '.join(f'{x:.3f}' for x in times['checkpoint'])} s, fit {fit_s:.2f} s, "
            f"max_memory_allocated {train_peak:.2f} GiB, last losses "
            f"{ {k: v for k, v in rows[-1].items() if k.startswith('val/')} }")
        run_dir = trainer.run_dir
        del trainer, state
        torch.cuda.empty_cache()

        # the Trainer iteration with and without segmentations: the same
        # steps without validation or checkpoints, so that the reader's
        # thread does not fill its queue while a validation runs
        iteration, step_s = {}, {}
        for segs in (True, False):
            kw = dict(cfg_kw) if segs else dict(cfg_kw, segs=False, recon_loss=("ncc",))
            timed_cfg = PULPoConfig(**kw, batch_size=1, max_epochs=steps,
                                    log_every_n_steps=2, val_check_interval=10.0)
            loaders = oasis.create_data_loaders(1, segs=segs, lms=False, path=key,
                                                seed=cfg.random_seed)
            timed = Trainer(timed_cfg, run_dir=run_root, experiment=f"oasis-segs={segs}",
                            device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            timed.fit(loaders[0], loaders[1], max_steps=steps)
            torch.cuda.synchronize()
            iteration[segs] = (time.perf_counter() - t) / steps
            step_s[segs] = statistics.median(timed.times["step"][1:])
            timed.close()
            del timed
            torch.cuda.empty_cache()

        # the reader alone: the one-hot pairs on the host, then their
        # pinned copy to the card
        t = time.perf_counter()
        host = list(train_loader)
        read_s = (time.perf_counter() - t) / len(host)
        t = time.perf_counter()
        for batch in prefetch_to_device(iter(host), dev):
            torch.cuda.current_stream().synchronize()
        copy_s = (time.perf_counter() - t) / len(host)
        batch_bytes = sum(v.nbytes for v in host[0].values())
        del host
        share = {k: (iteration[k] - step_s[k]) / iteration[k] for k in iteration}
        log(f"oasis loader: {batch_bytes / 2**30:.2f} GiB a B = 1 batch with segmentations; "
            f"read and one-hot {read_s:.3f} s a batch, pinned copy {copy_s:.3f} s a batch "
            f"({batch_bytes / copy_s / 1e9:.1f} GB/s); Trainer iteration (no validation) with "
            f"segmentations {iteration[True]:.3f} s (step {step_s[True]:.3f} s), without "
            f"{iteration[False]:.3f} s (step {step_s[False]:.3f} s); the loader's share of the "
            f"iteration with segmentations {share[True]:.3f}, without {share[False]:.3f}")

        # the tables, through the evaluation entry point
        ev = Evaluate(device=dev)
        ev.load_model(run_dir)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with RecordedRequests(n_samples) as rec:
            perf, unc = ev.run_one_model(segs=True, lms=True, N=n_samples, task="oasis",
                                         data_path=key, visualize=False)
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t
        eval_counts = read_counts()
        eval_peak = torch.cuda.max_memory_allocated() / 2**30
    expect(eval_counts, table_launches(cfg, pairs, seg_pairs, rec.decodes),
           f"oasis tables ({rec.decodes} decodes, chunks {rec.chunks})")
    lm_cols = ("LM_MAE", "LM_Euclid", "LM_VAR", "LM_NCC")
    check_table(perf, lambda s, m, r: m == "JDetLeq0" or (m == "Dice" and s == "test_lm")
                or (m in lm_cols and (s != "test_lm" or r > 0)), "oasis performance table")
    check_table(unc, lambda s, m, r: m in lm_cols and s != "test_lm", "oasis uncertainty table")
    for s in ("train", "val", "test_seg"):
        if not np.isfinite(perf[(s, "Dice")]).all():
            raise SystemExit(f"oasis performance table: ({s}, Dice) not finite")
    for table, need in ((perf, ("LM_MAE", "LM_Euclid")), (unc, ("LM_VAR", "LM_NCC"))):
        for m in need:
            if not np.isfinite(table[("test_lm", m)][0]):
                raise SystemExit(f"oasis tables: no finite (test_lm, {m})")
    log(f"oasis tables: {tables_s:.3f} s for both (N={n_samples}), max_memory_allocated "
        f"{eval_peak:.2f} GiB, checkpoint {ev.loaded_checkpoint}")
    log("oasis performance table (deterministic):\n" + str(perf))
    log("oasis uncertainty table:\n" + str(unc))
    info = {"run_dir": run_dir, "step_s": step_s[True], "iteration_s": iteration[True],
            "plain_step_s": step_s[False], "plain_iteration_s": iteration[False],
            "read_s": read_s, "copy_s": copy_s,
            "train_peak_gib": train_peak, "tables_s": tables_s, "eval_peak_gib": eval_peak}
    return train_counts, eval_counts, info, stores


def grad_spread(grads, ref):
    """How far one set of gradients is from another: (the relative L2
    distance over the whole network, the worst leaf as a share of its own
    scale, that leaf). A leaf's scale is at least 1 % of the largest
    gradient: a conv bias that feeds a train BatchNorm has gradient 0 in
    exact arithmetic, so its values are rounding noise."""
    top = max(float(g.abs().max()) for g in ref.values())
    diff = sum(float((g.double() - ref[n].double()).square().sum()) for n, g in grads.items())
    norm = sum(float(g.double().square().sum()) for g in ref.values())
    worst = max((float((g.float() - ref[n].float()).abs().max())
                 / max(float(ref[n].abs().max()), 1e-2 * top), n) for n, g in grads.items())
    return (diff / norm) ** 0.5, *worst


def run_remat_path(dev, cfg_kw, stores):
    """Phase 8b: the OASIS segmentation step at B = 2 (one batch of the
    reader's training loader) three ways on fresh models from seed 0:
    plain, `remat_down=(0,)` and `remat=True`, each twice (the first
    run's peak and gradients, the second's time). Checks: the loss equal
    (the forward has no atomics), the BatchNorm statistics equal, exact
    launch counts, the remat peaks below the plain one, and the
    gradients no further from the plain step's (relative L2 over the
    network) than the plain step's own second run is (twice that, or
    1e-5): the backward's float atomics (#2) change the last bits from
    run to run, and in bfloat16 a last bit that moves a rounding moves a
    gradient by more than that bit."""
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data import oasis
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    key = next(iter(stores))
    with memory_stores(stores):
        loader = oasis.create_data_loaders(2, segs=True, lms=False, path=key, seed=0)[0]
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(iter(loader)).items()}
    results, counts, peaks, times = {}, {}, {}, {}
    total = {}
    for name, knob in (("plain", {}), ("remat_down=(0,)", {"remat_down": (0,)}),
                       ("remat", {"remat": True})):
        cfg = PULPoConfig(**cfg_kw, **knob, batch_size=2)
        expected = step_launches(cfg, 1, dice=True)
        for k, v in remat_launches(cfg, 1).items():
            expected[k] += v
        for run in range(2):
            model = PULPoModel(cfg, device=dev)
            model.init(0)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            grads, stats, metrics = compute_grads(model, batch, seed=5)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            c = read_counts()
            expect(c, expected, f"remat path, {name} run {run}")
            total = {k: total.get(k, 0) + v for k, v in c.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"remat path {name} run {run}: B = 2 step (forward and backward) {dt:.3f} s, "
                f"total_loss {float(metrics['total_loss']):.6f}, max_memory_allocated "
                f"{peak:.2f} GiB")
            results[(name, run)] = (grads, stats, float(metrics["total_loss"]))
            if run == 0:
                peaks[name] = peak
            else:
                times[name] = dt
            del model, grads, stats, metrics
    ref_grads, ref_stats, ref_loss = results[("plain", 0)]
    spread = grad_spread(results[("plain", 1)][0], ref_grads)[0]
    for key_ in (("plain", 1), ("remat_down=(0,)", 0), ("remat_down=(0,)", 1), ("remat", 0),
                 ("remat", 1)):
        grads, stats, loss = results[key_]
        rel, worst, leaf = grad_spread(grads, ref_grads)
        stats_equal = all(torch.equal(v, ref_stats[n]) for n, v in stats.items())
        log(f"remat path {key_[0]} run {key_[1]} vs plain run 0: loss "
            f"{'equal' if loss == ref_loss else f'differs by {loss - ref_loss:.3e}'}, gradients "
            f"{rel:.3e} apart (relative L2 over the network), the worst leaf {worst:.3e} of "
            f"its scale ({leaf}), BatchNorm statistics {'equal' if stats_equal else 'DIFFER'}")
        if loss != ref_loss or not stats_equal or rel > max(2 * spread, 1e-5):
            raise SystemExit(f"remat path: {key_} differs from the plain step")
    for name in ("remat_down=(0,)", "remat"):
        if not peaks[name] < peaks["plain"]:
            raise SystemExit(f"remat path: {name} peak {peaks[name]:.2f} GiB not below the "
                             f"plain {peaks['plain']:.2f} GiB")
    return total, {"peaks": peaks, "times": times, "spread": spread}


def run_brats_path(dev, steps, run_root):
    """Phase 8c: `train_cli` with its defaults (`--dataset brats`: the
    flagship network in float32, B = 1) on an in-memory BraTS store at
    144x192x160: `steps` steps with validation after each, finite
    losses, exact launch counts, a `latest` checkpoint that reloads bit
    for bit."""
    import torch

    from pulpo_tpu_torch import train_cli
    from pulpo_tpu_torch.train.checkpoint import CheckpointManager
    from pulpo_tpu_torch.train.metrics import read_metrics

    key = "memory://BraTS.h5"
    stores = {key: brats_store(BRATS_SIZE, BRATS_SPLITS, seed=90)}
    accelerator = "gpu" if dev.type == "cuda" else "cpu"
    with memory_stores(stores):
        reset_counts()
        t = time.perf_counter()
        run_dir = train_cli.main(["--data_path", key, "--max_steps", str(steps), "--skip_eval",
                                  "--run_dir", str(run_root), "--accelerator", accelerator])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    counts = read_counts()
    cfg = CheckpointManager.load_config(run_dir)
    if cfg.dataset != "brats" or tuple(cfg.input_size) != BRATS_SIZE:
        raise SystemExit(f"brats: {cfg.dataset} {cfg.input_size}")
    rows = read_metrics(run_dir)
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise SystemExit(f"brats: validation rows {[r['step'] for r in rows]}")
    for r in rows:
        if not all(math.isfinite(r[f"val/{k}"]) for k in ("kl_loss", "reconstruction_loss",
                                                          "regularization_loss", "total_loss")):
            raise SystemExit(f"brats: step {r['step']} validation losses {r}")
    # validation after every step (2 pairs x 0.1 < 1), over the validation pairs
    expect(counts, step_launches(cfg, steps, BRATS_SPLITS[1] * steps),
           f"brats train_cli ({steps} steps)")
    check_reload(run_dir, None, cfg, dev, "brats")
    log(f"brats train_cli: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} n0 "
        f"{cfg.n0} {cfg.compute_dtype}, {steps} steps with validation in {fit_s:.2f} s, val "
        f"total_loss {' '.join(str(r['val/total_loss']) for r in rows)}, checkpoint reloads bit "
        "for bit")
    return counts, {"fit_s": fit_s}


def read_table(path):
    """A table that `eval/tables.make_tables` wrote as csv."""
    import csv

    from pulpo_tpu_torch.eval.tables import Table

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return Table([[float(v) for v in r[1:]] for r in rows[2:]],
                 list(zip(rows[0][1:], rows[1][1:])), index=[r[0] for r in rows[2:]])


def run_oasis_2d(dev, steps, n_samples, run_root):
    """Phase 7c: `train_cli --ndims 2 --dataset oasis --segs --lms
    --recon_loss ncc dice` (the CLI's default network, float32) on an
    in-memory 2D OASIS store at 160x192: `steps` steps with validation
    after each, then the evaluation the CLI runs (the performance table
    with Dice and the landmark columns, the N = 10 uncertainty table):
    every entry finite but the reference's NaNs, exact launch counts."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import train_cli
    from pulpo_tpu_torch.train.checkpoint import CheckpointManager
    from pulpo_tpu_torch.train.metrics import read_metrics

    key = "memory://OASIS-2d.h5"
    stores = {key: oasis_store(FLAGSHIP_2D["input_size"], OASIS_SPLITS, seed=70)}
    accelerator = "gpu" if dev.type == "cuda" else "cpu"
    with memory_stores(stores), RecordedRequests(n_samples) as rec:
        reset_counts()
        t = time.perf_counter()
        run_dir = train_cli.main(["--ndims", "2", "--dataset", "oasis", "--segs", "--lms",
                                  "--recon_loss", "ncc", "dice", "--data_path", key,
                                  "--max_steps", str(steps), "--run_dir", str(run_root),
                                  "--accelerator", accelerator])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    counts = read_counts()
    cfg = CheckpointManager.load_config(run_dir)
    rows = read_metrics(run_dir)
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise SystemExit(f"oasis 2D: validation rows {[r['step'] for r in rows]}")
    K, nsteps = cfg.latent_levels, cfg.nsteps
    pairs, seg_pairs = sum(OASIS_SPLITS), sum(OASIS_SPLITS[:3])
    forwards = steps + OASIS_SPLITS[1] * steps  # validation after every step
    train = train_launches(cfg, steps, OASIS_SPLITS[1] * steps)
    train["warp_2d"] += K * forwards  # the one-hot map at each level of each forward
    tables = table_launches(cfg, pairs, seg_pairs, rec.decodes)
    expect(counts, {k: train.get(k, 0) + tables.get(k, 0) for k in set(train) | set(tables)},
           f"oasis 2D train_cli and tables ({rec.decodes} decodes, chunks {rec.chunks})")
    perf = read_table(run_dir / "evaluation" / "loss" / "loss_table_deterministic.csv")
    unc = read_table(run_dir / "evaluation" / "uncertainty" / "loss_table.csv")
    lm_cols = ("LM_MAE", "LM_Euclid", "LM_VAR", "LM_NCC")
    check_table(perf, lambda s, m, r: m == "JDetLeq0" or (m == "Dice" and s == "test_lm")
                or (m in lm_cols and (s != "test_lm" or r > 0)), "oasis 2D performance table")
    check_table(unc, lambda s, m, r: m in lm_cols and s != "test_lm", "oasis 2D uncertainty table")
    if not np.isfinite(perf[("test_seg", "Dice")]).all():
        raise SystemExit("oasis 2D performance table: (test_seg, Dice) not finite")
    log(f"oasis 2D train_cli: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.recon_loss}, {steps} steps with validation and "
        f"the tables in {total_s:.2f} s; val total_loss "
        f"{' '.join(str(r['val/total_loss']) for r in rows)}")
    log("oasis 2D performance table:\n" + str(perf))
    log("oasis 2D uncertainty table:\n" + str(unc))
    return counts, run_dir, stores


# ----------------------------------------------------------------------
# phases 9, 9b, 9c, 9d: the figures, the validation panels, the
# DIF-VoxelMorph baseline and compare_models
# ----------------------------------------------------------------------

VXM_SAMPLES = 10               # N of the VoxelMorph uncertainty table
VXM_STEPS = 3                  # VoxelMorph training steps
VXM_SMALL = (24, 28, 32)       # the card-against-CPU check's size
COMPARE_SAMPLES = 2            # N of compare_models' mean-SVF predictions (reduced)
VAL_TAGS = ("val/x", "val/y", "val/y_pred", "val/distance", "val/DF")


class RecordedWarps:
    """Notes the (moving, df) shapes of each image-warp launch while open
    (`kernels/warp._warp_kernel`, 3D and 2D), for per-path device times,
    and of each df-cotangent launch (`warp_dfgrad`) in `dfgrad_shapes`."""

    def __enter__(self):
        from pulpo_tpu_torch.kernels import warp

        self.shapes, self.dfgrad_shapes = [], []
        self.fns = fn, dfgrad = warp._warp_kernel, warp.warp_dfgrad

        def recorded(moving, df, *slab):
            self.shapes.append((tuple(moving.shape), tuple(df.shape)))
            return fn(moving, df, *slab)

        def recorded_dfgrad(moving, df, g, *slab):
            self.dfgrad_shapes.append((tuple(moving.shape), tuple(df.shape)))
            return dfgrad(moving, df, g, *slab)

        warp._warp_kernel, warp.warp_dfgrad = recorded, recorded_dfgrad
        return self

    def __exit__(self, *exc):
        from pulpo_tpu_torch.kernels import warp

        warp._warp_kernel, warp.warp_dfgrad = self.fns

    def by_channels(self) -> tuple[dict[int, int], dict[int, int]]:
        """Launches of the 3D warp and of its df-cotangent by the moving
        map's channel count."""
        count = lambda shapes: {c: sum(1 for m, d in shapes if len(d) == 5 and m[-1] == c)
                                for c in sorted({m[-1] for m, d in shapes if len(d) == 5})}
        return count(self.shapes), count(self.dfgrad_shapes)


def figure_launches(cfg, loaders, seg_loaders, uq_decodes, requests):
    """Launches of `Evaluate.write_figures` over `loaders` loaders (one
    pair each, `seg_loaders` with segmentations) whose N-sample
    predictions made `uq_decodes` decodes in `requests` requests. Per
    loader: the deterministic prediction (an encode and a decode, one
    `combine_dfs`), the one-sample prediction (an encode and a decode,
    `PULPoModel.predict`'s `combine_dfs` and level warps, then
    `Evaluate.predict`'s `combine_dfs`) and the N-sample one (its
    requests' decodes and mean-SVF tails, then a `combine_dfs`); each
    prediction warps the one-hot map by every level's final df. In 2D
    the N-sample prediction also warps the map by each sample's final df
    (N rows a level, one launch)."""
    K, nsteps = cfg.latent_levels, cfg.nsteps
    sq, wp = ("squaring_2d", "warp_2d") if cfg.ndims == 2 else ("squaring", "warp")
    combines = 4 * loaders
    tails = requests
    seg_warps = 3 * K * seg_loaders + (K * seg_loaders if cfg.ndims == 2 else 0)
    return add_counts(
        decode_launches(cfg, 2 * loaders + uq_decodes, 3 * loaders),
        {sq: nsteps * K * (combines + tails),
         wp: K * loaders + K * tails + seg_warps})


def check_panel_files(vis_dir, loader_names, n, segs, ndims):
    """Each loader's three figures: `.npz` panels whose row count is the
    default menu's and whose images are finite; a `.png` beside each only
    where matplotlib is installed. Returns the files' names."""
    import importlib.util

    import numpy as np

    from pulpo_tpu_torch.eval import visualize as vis

    png = importlib.util.find_spec("matplotlib") is not None
    names = []
    for loader in loader_names:
        for pred in ("deterministic", "sample", f"avg_{n}"):
            base = vis_dir / f"allvis{loader}_{pred}"
            p = vis.load_panels(base.with_suffix(".npz"))
            uq = pred.startswith("avg")
            has_segs = segs and loader != "test_lm"
            rows = vis.default_visualizations(has_segs, uq, uq and has_segs and ndims == 2)[0]
            if p.rows != len(rows):
                raise SystemExit(f"figure {base.name}: {p.rows} rows, the menu has {len(rows)}")
            for r, row in enumerate(p.axes):
                for c, a in enumerate(row):
                    if a.image is not None and not np.isfinite(a.image.astype(np.float64)).all():
                        raise SystemExit(f"figure {base.name}: row {rows[r]} column {c} not "
                                         "finite")
            if base.with_suffix(".png").exists() != png:
                raise SystemExit(f"figure {base.name}: png {base.with_suffix('.png').exists()}, "
                                 f"matplotlib {'installed' if png else 'absent'}")
            names.append(base.name + (".npz and .png" if png else ".npz"))
    return names


def run_figure_path(dev, run_dir, stores, n_samples, what):
    """Phases 9 and 9b: the evaluation CLI's default command, `evaluate_cli
    --run_dir <run> --task oasis --segs --lms --N 10` without
    `--no_visualize` (`Evaluate.run_one_model(visualize=True)`), on a
    trained run's directory and its in-memory store: per loader three
    predictions, their figures' panels (`vis/*.npz`, checked by
    `check_panel_files`) and JDet tables, then the performance and
    uncertainty tables; exact launch counts. Returns (counts, info) with
    the time, the peak and the C = 36 one-hot warps' shapes."""
    import torch

    from pulpo_tpu_torch import evaluate_cli
    from pulpo_tpu_torch.train.checkpoint import CheckpointManager

    cfg = CheckpointManager.load_config(run_dir)
    out = run_dir / "evaluation"
    key = next(iter(stores))
    accelerator = "gpu" if dev.type == "cuda" else "cpu"
    with memory_stores(stores):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with RecordedRequests(n_samples) as rec, RecordedWarps() as warps:
            perf, unc = evaluate_cli.main([
                "--run_dir", str(run_dir), "--task", "oasis", "--segs", "--lms", "--N",
                str(n_samples), "--data_path", key, "--accelerator", accelerator])
        torch.cuda.synchronize()
        fig_s = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    loaders = ("train", "val", "test_seg", "test_lm")  # the OASIS task's
    n_loaders = len(loaders)
    # the figures' requests come first (one a loader), then the tables'
    fig_decodes = sum(rec.per_request[:n_loaders])
    table_decodes = rec.decodes - fig_decodes
    pairs, seg_pairs = sum(OASIS_SPLITS), sum(OASIS_SPLITS[:3])
    expected = add_counts(figure_launches(cfg, n_loaders, n_loaders - 1, fig_decodes, n_loaders),
                          table_launches(cfg, pairs, seg_pairs, table_decodes))
    expect(counts, expected, f"{what} figure path ({rec.decodes} decodes, chunks {rec.chunks})")
    names = check_panel_files(out / "vis", loaders, n_samples, True, cfg.ndims)
    jdet = sorted(p.name for p in (out / "jdet").glob("*.csv"))
    if len(jdet) != 3 * n_loaders:
        raise SystemExit(f"{what} figure path: jdet tables {jdet}")
    for p in (out / "jdet").glob("*.csv"):
        if not all(math.isfinite(v) for v in read_table(p).values.ravel()):
            raise SystemExit(f"{what} figure path: {p.name} not finite")
    lm_cols = ("LM_MAE", "LM_Euclid", "LM_VAR", "LM_NCC")
    check_table(perf, lambda s, m, r: m == "JDetLeq0" or (m == "Dice" and s == "test_lm")
                or (m in lm_cols and (s != "test_lm" or r > 0)), f"{what} figure path table")
    check_table(unc, lambda s, m, r: m in lm_cols and s != "test_lm", f"{what} figure path "
                "uncertainty table")
    seg_warps = [s for s in warps.shapes if s[0][-1] == SEG_CLASSES]
    log(f"{what} figure path: evaluate_cli (run_one_model(visualize=True)) {fig_s:.3f} s "
        f"(figures and tables), max_memory_allocated {peak:.2f} GiB; wrote {len(names)} figures ("
        f"{', '.join(names)}) and {len(jdet)} jdet tables; {len(seg_warps)} one-hot warps at "
        f"C = {SEG_CLASSES}")
    return counts, {"fig_s": fig_s, "peak_gib": peak, "seg_warps": seg_warps,
                    "figures": len(names)}


def time_warp_shapes(dev, shapes):
    """Device ms (CUDA-graph replay) of the image warp at each distinct
    (moving, df) shape of `shapes` (a smooth 3-voxel field, a one-hot
    map for C = 36), and their sum over `shapes`: a path's device ms."""
    from collections import Counter

    from pulpo_tpu_torch.kernels import warp

    fmt = lambda s: "x".join(map(str, s))
    per, total = {}, 0.0
    for (mshape, dshape), n in sorted(Counter(shapes).items()):
        if mshape[-1] == SEG_CLASSES:
            moving = onehot_volume((1, *mshape[1:]), 350, dev).repeat_interleave(mshape[0], 0)
        else:
            moving = smooth_field(mshape[0], mshape[1:-1], 1.0, 351, dev, channels=mshape[-1])
        df = smooth_field(dshape[0], dshape[1:-1], 3.0, 352, dev, channels=dshape[-1])
        ms = graph_ms(lambda: warp.warp(moving, df), 5)
        per[f"moving {fmt(mshape)} df {fmt(dshape)}"] = {"launches": n, "ms": ms}
        total += n * ms
        del moving, df
    return per, total


def run_panels_check(run_dir):
    """Phase 9c: the validation panels that phase 8's Trainer wrote at
    every validation round (`image_logging_frequency = 1`): per round one
    `images/step_<s>.npz` whose keys are the JAX writer's tags, each a
    uint8 (H, W, 3) grid."""
    from pulpo_tpu_torch.train.metrics import read_images, read_metrics

    images = read_images(run_dir)
    val_steps = [r["step"] for r in read_metrics(run_dir) if "val/total_loss" in r]
    if list(images) != val_steps:
        raise SystemExit(f"validation panels at steps {list(images)}, validations at {val_steps}")
    for step, grids in images.items():
        levels = sorted({int(k.rsplit("_", 1)[1]) for k in grids if k.startswith("val_levels/")})
        tags = list(VAL_TAGS) + [f"val_levels/{n}_level_{l}" for l in levels
                                 for n in ("recon", "individual_DF", "final_DF")]
        if sorted(grids) != sorted(tags) or not levels:
            raise SystemExit(f"validation panels at step {step}: tags {sorted(grids)}")
        for tag, g in grids.items():
            if g.dtype.name != "uint8" or g.ndim != 3 or g.shape[-1] != 3:
                raise SystemExit(f"validation panel {tag} at step {step}: {g.dtype} {g.shape}")
    shapes = {k: v.shape for k, v in next(iter(images.values())).items()}
    log(f"validation panels: {len(images)} rounds (steps {list(images)}), "
        f"{len(shapes)} uint8 HWC grids a round: {shapes}")
    return len(images)


def check_vxm_small(dev, size=VXM_SMALL, n=4):
    """Phase 9d, first part: the VoxelMorph forward (deterministic) and an
    N = 4 `predict` with injected draws on the card against the CPU's
    plain versions, same weights: every output within 1e-5 of its scale."""
    import torch

    from pulpo_tpu_torch.models.voxelmorph import VxmModel

    models = {d: VxmModel(size, device=d) for d in ("cpu", dev)}
    models["cpu"].init(3)
    models[dev].load_state_dict(models["cpu"].state_dict())
    x, y = (smooth_field(1, size, 1.0, s, "cpu", channels=1).abs() for s in (360, 361))
    eps = torch.randn((n, 1, *models["cpu"].half_size, 3),
                      generator=torch.Generator().manual_seed(362))
    outs = {d: (m.apply(x, y, deterministic=True)[:2], m.predict(x, y, n, eps=eps))
            for d, m in models.items()}
    names = ["moved", "df", "avg_moved", "avg_df", "moved_std", "df_std", "all_moved", "all_dfs"]
    got = [*outs[dev][0], *outs[dev][1]]
    ref = [*outs["cpu"][0], *outs["cpu"][1]]
    worst = 0.0
    for name, g, r in zip(names, got, ref):
        rel = float((g.cpu().double() - r.double()).abs().max() / r.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if not rel <= 1e-5:
            raise SystemExit(f"vxm small: {name} card vs CPU {rel:.3e} of its scale")
    log(f"vxm small {size}: forward and N = {n} predict on the card vs the CPU, worst "
        f"{worst:.3e} of scale (tol 1e-5)")


def vxm_launches(passes, predicts, steps, nsteps=7):
    """Launches of the VoxelMorph paths: each forward (a deterministic or
    sampled pair, or an N-sample `predict`: one U-Net, all rows in one
    integration and one warp) one narrow conv (its 2 -> 16 first conv),
    nsteps squaring steps and one warp; each training step also nsteps
    squaring backward steps and one df-cotangent."""
    forwards = passes + predicts + steps
    return {"conv_narrow": forwards, "squaring": nsteps * forwards, "warp": forwards,
            "squaring_bwd": nsteps * steps, "warp_dfgrad": steps}


def time_vxm_kernels(dev, size, n):
    """Device ms (CUDA-graph replay) of #12, #1, #4, #2 and #6 at the
    VoxelMorph paths' shapes, {kernel: {shape: ms}}, and under "library"
    `F.conv3d` (cuDNN, float32, TF32 off) for #12 and `F.grid_sample` for
    #4 on the same inputs."""
    import torch

    from pulpo_tpu_torch.kernels import conv_narrow, squaring, warp

    half = tuple(-(-s // 2) for s in size)
    res = {"conv_narrow": {}, "squaring": {}, "warp": {}, "squaring_bwd": {}, "warp_dfgrad": {}}
    import torch.nn.functional as F

    x = smooth_field(1, size, 1.0, 370, dev, channels=2)
    w = narrow_weight(2, 16, 371, dev)
    res["conv_narrow"]["2->16 f32"] = graph_ms(lambda: conv_narrow.conv_narrow(x, w), 5)
    x_cf = x.permute(0, 4, 1, 2, 3).contiguous()
    res["library"] = {"conv_narrow 2->16 f32 (F.conv3d)": graph_ms(
        lambda: F.conv3d(x_cf, w, padding=1), 5)}
    moving = smooth_field(1, size, 1.0, 372, dev, channels=1)
    for rows in (1, n):
        v = smooth_field(rows, half, 3.0 / 2**7, 373, dev)
        res["squaring"][f"{rows} rows"] = graph_ms(lambda: squaring.squaring_step(v), 5)
        df = smooth_field(rows, size, 3.0, 374, dev)
        res["warp"][f"{rows} rows"] = graph_ms(lambda: warp.warp(moving, df), 5)
        m_cf = moving.permute(0, 4, 1, 2, 3).expand(rows, -1, -1, -1, -1).contiguous()
        grid = grid_for(df)
        res["library"][f"warp {rows} rows (F.grid_sample)"] = graph_ms(
            lambda: F.grid_sample(m_cf, grid, mode="bilinear", padding_mode="border",
                                  align_corners=False), 5)
        if rows == 1:
            g = torch.randn_like(v)
            res["squaring_bwd"]["1 row"] = graph_ms(lambda: squaring.squaring_step_bwd(v, g), 5)
            gw = torch.randn((1, *size, 1), device=dev)
            res["warp_dfgrad"]["1 row"] = graph_ms(
                lambda: warp.warp_dfgrad(moving, df, gw), 5)
        del v, df, grid, m_cf
    return res


def run_vxm_path(dev, size, stores, n_samples, steps, out_root):
    """Phase 9d: the DIF-VoxelMorph baseline at the flagship's size with
    weights from seed 0, on phase 8's OASIS store (10 pairs, landmarks on
    test_lm): `performance_vxm(1)`, `uncertainty_vxm(N)` and
    `performance_vxm(artifact="blur")`, which must differ from the clean
    table; then `steps` VoxelMorph-diff steps (torch Adam, lr 1e-4) on one
    pair with a finite loss. Exact launch counts, the pair times (CUDA
    events) and the peaks."""
    import numpy as np
    import torch

    from pulpo_tpu_torch.eval.evaluator import Evaluate
    from pulpo_tpu_torch.models.voxelmorph import VxmModel, make_vxm_train_step

    init = VxmModel(size, device=dev)
    weights = init.init(0)
    del init
    ev = Evaluate(device=dev)
    key = next(iter(stores))
    with memory_stores(stores):
        ev.load_data(task="oasis", segs=False, lms=True, mask=False, path=key)
        batch = next(iter(ev.loaders[0]))
    ev.load_vxm(weights, size, output_dir=out_root / "vxm")
    pairs = sum(len(dl.dataset) for dl in ev.loaders)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with memory_stores(stores):
        perf = ev.performance_vxm(1)
        t_perf = time.perf_counter()
        unc = ev.uncertainty_vxm(n_samples)
        t_unc = time.perf_counter()
        blur = ev.performance_vxm(1, artifact="blur")
    torch.cuda.synchronize()
    tables = (t_perf - t, t_unc - t_perf, time.perf_counter() - t_unc)
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    eval_counts = read_counts()
    expect(eval_counts, vxm_launches(2 * pairs, pairs, 0), f"vxm tables ({pairs} pairs)")
    lm = ("LM_MAE", "LM_Euclid", "LM_VAR", "LM_NCC")
    for table, name in ((perf, "performance"), (unc, "uncertainty"), (blur, "blur")):
        check_table(table, lambda s, m, r: m == "JDetLeq0" or (m in lm and s != "test_lm"),
                    f"vxm {name} table")
    if np.array_equal(perf.values, blur.values, equal_nan=True):
        raise SystemExit("vxm: the blurred table equals the clean one")
    if not (out_root / "vxm" / "loss" / "loss_table_vxmblur.csv").exists():
        raise SystemExit("vxm: no loss_table_vxmblur.csv")
    log("vxm performance table:\n" + str(perf))
    log("vxm uncertainty table:\n" + str(unc))
    log("vxm performance table, blurred moving images:\n" + str(blur))

    # training
    model = ev.vxm
    tx = torch.optim.Adam(model.module.parameters(), lr=1e-4)
    step = make_vxm_train_step(model, tx, seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        m = step(batch)
        losses.append(float(m["total_loss"]))
        step_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    train_counts = read_counts()
    expect(train_counts, vxm_launches(0, 0, steps), f"vxm training ({steps} steps)")
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"vxm training losses {losses}")
    if all(torch.equal(before[k], v) for k, v in model.state_dict().items()):
        raise SystemExit("vxm training changed no weight")
    model.load_state_dict(before)
    log(f"vxm training: {steps} steps, total_loss {' '.join(f'{v:.6f}' for v in losses)}, "
        f"step {' '.join(f'{s:.3f}' for s in step_s)} s, max_memory_allocated "
        f"{train_peak:.2f} GiB")

    # a pair's times on the device (CUDA events)
    x = torch.as_tensor(batch["x"], device=dev)
    y = torch.as_tensor(batch["y"], device=dev)
    torch.cuda.reset_peak_memory_stats()
    det_ms = time_ms(lambda: model.apply(x, y, deterministic=True), 3)
    pred_ms = time_ms(lambda: model.predict(x, y, n_samples, seed=1), 1)
    pair_peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = time_ms(lambda: step(batch), 1)
    model.load_state_dict(before)
    log(f"vxm pair {size}: deterministic forward {det_ms:.3f} ms, N = {n_samples} predict "
        f"{pred_ms:.3f} ms (max_memory_allocated {pair_peak:.2f} GiB), training step "
        f"{step_ms:.3f} ms; tables {' '.join(f'{s:.3f}' for s in tables)} s (performance, "
        f"uncertainty, blurred) with peak {eval_peak:.2f} GiB")
    return add_counts(eval_counts, train_counts), {
        "eval_counts": eval_counts, "train_counts": train_counts, "det_ms": det_ms,
        "pred_ms": pred_ms, "step_ms": step_ms, "pair_peak_gib": pair_peak,
        "eval_peak_gib": eval_peak, "train_peak_gib": train_peak, "tables_s": tables,
        "pairs": pairs}


def compare_launches(cfg, pairs, seg_pairs, n):
    """Launches of `compare_models` for one model over `pairs` pairs
    (`seg_pairs` with segmentations): per pair `PULPoModel.predict` (an
    encode, a decode of the N samples as one batch, a `combine_dfs` and
    the level warps), then a `combine_dfs` and, with segmentations, the
    level-0 one-hot warp."""
    K, nsteps = cfg.latent_levels, cfg.nsteps
    return add_counts(decode_launches(cfg, pairs, pairs),
                      {"squaring": 2 * nsteps * K * pairs, "warp": K * pairs + seg_pairs})


def run_compare_path(dev, run_dir, stores, n, out_root):
    """Phase 9e: `Evaluate.compare_models` over phase 8's run and a second
    run of the same config with weights from seed 1, at N = `n` (reduced)
    on phase 8's store with segmentations: one row a model, no NaN where a
    metric applies (Dice has none on test_lm), exact launch counts, the
    table files."""
    import numpy as np
    import torch

    from pulpo_tpu_torch.eval.evaluator import Evaluate
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train import create_train_state
    from pulpo_tpu_torch.train.checkpoint import CheckpointManager

    cfg = CheckpointManager.load_config(run_dir)
    second = out_root / "seed1"
    state, _ = create_train_state(PULPoModel(cfg, device=dev), seed=1)
    CheckpointManager(second, cfg).save_latest(state, 0)
    del state
    torch.cuda.empty_cache()
    key = next(iter(stores))
    ev = Evaluate(device=dev)
    reset_counts()
    t = time.perf_counter()
    with memory_stores(stores):
        table = ev.compare_models([run_dir, second], model_names=["oasis", "seed1"],
                                  task="oasis", segs=True, lms=False, N=n, data_path=key,
                                  output_dir=out_root / "compare")
    torch.cuda.synchronize()
    cmp_s = time.perf_counter() - t
    counts = read_counts()
    pairs, seg_pairs = sum(OASIS_SPLITS), sum(OASIS_SPLITS[:3])
    one = compare_launches(cfg, pairs, seg_pairs, n)
    expect(counts, {k: 2 * v for k, v in one.items()}, "compare_models (2 models)")
    if table.index != ["oasis", "seed1"] or table.shape != (2, 16):
        raise SystemExit(f"compare_models: index {table.index}, shape {table.shape}")
    for c, (s, m) in enumerate(table.columns):
        if not (m == "Dice" and s == "test_lm") and np.isnan(table.values[:, c]).any():
            raise SystemExit(f"compare_models: NaN in ({s}, {m})")
    for ext in ("csv", "tex"):
        if not (out_root / "compare" / f"loss_table.{ext}").exists():
            raise SystemExit(f"compare_models: no loss_table.{ext}")
    log(f"compare_models: 2 models x {pairs} pairs at N = {n} in {cmp_s:.3f} s\n{table}")
    return counts, {"compare_s": cmp_s}


# ----------------------------------------------------------------------
# phase 6: times
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# phases 10-10d: the native loader, ingest and data parallelism
# ----------------------------------------------------------------------

INGEST_RAW = (240, 240, 155)    # BraTS's raw t1ce volume
INGEST_TARGET = (144, 192, 160)  # the converted BraTS volume
DP_SIZE = (64, 64, 64)          # phase 10d's BraTS store
DP_SPLITS = (40, 2, 2)          # 20 global batches of 2: one validation in 2 steps
DP_STEPS = 2
DP_WORLD = 2
DP_TIMED_STEPS = 3              # phase 10c, after a warm-up step


def run_native_path(dev, cfg_kw, steps, stores, oasis, run_root):
    """Phase 10: phase 8's OASIS store (its training and validation
    splits) converted to volume stores (`native.convert_h5_to_store`,
    which writes them with `write_volume_store`) and served by the C++
    loader (`native.NativeDataset`, built with g++ here) through the
    port's `DataLoader` and `prefetch_to_device` to the OASIS Trainer
    (B = 1, NCC + Dice, 36 one-hot classes) for `steps` steps without
    validation, as phase 8 times its h5py reader. The first batch must
    equal `convert_to_onehot` of the same labels bit for bit; the launch
    counts must be exact, #4 and #6 at C = 36 counted apart."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig, native
    from pulpo_tpu_torch.data.loader import DataLoader, _collate
    from pulpo_tpu_torch.data.oasis import convert_to_onehot
    from pulpo_tpu_torch.train.loop import Trainer
    from pulpo_tpu_torch.train.metrics import read_metrics

    cfg = PULPoConfig(**cfg_kw, batch_size=1, max_epochs=steps, log_every_n_steps=1,
                      val_check_interval=10.0)
    key = next(iter(stores))
    run_root.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    with memory_stores(stores):
        paths = {split: native.convert_h5_to_store(key, split, run_root / f"{split}.bin",
                                                   with_segs=True)
                 for split in ("training", "validation")}
    convert_s = time.perf_counter() - t
    t = time.perf_counter()
    train_ds = native.NativeDataset(paths["training"], segs=True, n_slots=2)
    val_ds = native.NativeDataset(paths["validation"], segs=True, n_slots=2)
    open_s = time.perf_counter() - t
    group = stores[key]["training"]
    n = int(group.attrs["N"])
    if (len(train_ds), train_ds.input_size, train_ds.num_classes) != (n, cfg.input_size,
                                                                    SEG_CLASSES):
        raise SystemExit(f"native store: {len(train_ds)} items {train_ds.input_size} "
                         f"{train_ds.num_classes} classes")
    log(f"native path: {n} + {len(val_ds)} volumes converted to stores in {convert_s:.2f} s "
        f"({paths['training'].stat().st_size} B training), opened (g++ build, slots) in "
        f"{open_s:.2f} s")
    K = cfg.latent_levels
    try:
        # the first batch of the Trainer's loader, against the host one-hot
        first = next(iter(DataLoader(train_ds, 1, shuffle=True, seed=cfg.random_seed)))
        which = {}
        for k in ("x", "y"):
            match = [i for i in range(n) if np.array_equal(first[k][0, ..., 0],
                                                           group["image"][str(i)])]
            if len(match) != 1:
                raise SystemExit(f"native path: the first batch's {k} is no store volume")
            which[k] = match[0]
        for k, i in (("seg_x", which["x"]), ("seg_y", which["y"])):
            ref = convert_to_onehot(np.asarray(group["seg"][str(i)]), SEG_CLASSES)
            if first[k].dtype != ref.dtype or not np.array_equal(first[k][0], ref):
                raise SystemExit(f"native path: the first batch's {k} differs from "
                                 "convert_to_onehot of the same labels")
        del first
        log(f"native path: the first batch (volumes {which['x']} and {which['y']}) equals the "
            "store's volumes and convert_to_onehot of their labels bit for bit")

        # the loader alone: read and one-hot a batch; then its parts: a
        # pair from the C++ loader (its fill and one-hot, then the copy
        # out of the slot), that copy alone, and the collate
        t = time.perf_counter()
        host = list(DataLoader(train_ds, 1, shuffle=True, seed=cfg.random_seed))
        read_s = (time.perf_counter() - t) / len(host)
        del host
        rng = np.random.default_rng(0)
        t = time.perf_counter()
        items = [train_ds.get_pair(i, rng) for i in range(n)]
        pair_s = (time.perf_counter() - t) / n
        t = time.perf_counter()
        for item in items:
            [v.copy() for v in item.values() if v is not None]
        copy_s = (time.perf_counter() - t) / n
        t = time.perf_counter()
        for item in items:
            _collate([item])
        collate_s = (time.perf_counter() - t) / n
        del items

        trainer = Trainer(cfg, run_dir=run_root, experiment="oasis-native", device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with RecordedWarps() as rec:
            state = trainer.fit(DataLoader(train_ds, 1, shuffle=True, seed=cfg.random_seed),
                                DataLoader(val_ds, 1, seed=cfg.random_seed + 1),
                                max_steps=steps)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        counts = read_counts()
        trainer.close()
    finally:
        train_ds.close()
        val_ds.close()
    times = trainer.times["step"]
    if len(times) != steps or state.nan_flag:
        raise SystemExit(f"native path: {len(times)} steps, nan_flag {state.nan_flag}")
    rows = read_metrics(trainer.run_dir)
    for row in rows:
        if not all(math.isfinite(row[f"train/{k}"]) for k in ("kl_loss", "reconstruction_loss",
                                                             "regularization_loss",
                                                             "total_loss")):
            raise SystemExit(f"native path: step {row['step']} losses {row}")
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise SystemExit(f"native path: logged steps {[r['step'] for r in rows]}")
    expect(counts, step_launches(cfg, steps, dice=True), f"native path ({steps} steps)")
    by_c = rec.by_channels()
    c36 = {"warp": by_c[0].get(SEG_CLASSES, 0), "warp_dfgrad": by_c[1].get(SEG_CLASSES, 0)}
    if c36 != {"warp": K * steps, "warp_dfgrad": K * steps} or \
            sum(by_c[0].values()) != counts["warp"]:
        raise SystemExit(f"native path: C = {SEG_CLASSES} launches {c36}, by channels {by_c}")
    iteration = fit_s / steps
    step_s = statistics.median(times[1:])
    share = (iteration - step_s) / iteration
    h5_share = (oasis["iteration_s"] - oasis["step_s"]) / oasis["iteration_s"]
    log(f"native path: launches at C = {SEG_CLASSES}: #4 {c36['warp']}, #6 "
        f"{c36['warp_dfgrad']} (by channel count: #4 {by_c[0]}, #6 {by_c[1]})")
    log(f"native path: steps {' '.join(f'{x:.3f}' for x in times)} s, losses "
        f"{' '.join(str(r['train/total_loss']) for r in rows)}")
    log(f"native loader: read and one-hot {read_s:.3f} s a batch (phase 8's h5py reader "
        f"{oasis['read_s']:.3f} s): a pair from the C++ loader {pair_s:.3f} s (of which the "
        f"copy out of its slot, timed alone, {copy_s:.3f} s), the collate {collate_s:.3f} s; "
        f"Trainer iteration (no validation) {iteration:.3f} s "
        f"(step {step_s:.3f} s), phase 8's {oasis['iteration_s']:.3f} s (step "
        f"{oasis['step_s']:.3f} s); the loader's share of the iteration {share:.3f}, phase "
        f"8's h5py reader {h5_share:.3f}")
    return counts, {"read_s": read_s, "iteration_s": iteration, "step_s": step_s,
                    "share": share, "h5_share": h5_share, "c36": c36, "convert_s": convert_s,
                    "pair_s": pair_s, "copy_s": copy_s, "collate_s": collate_s}


def run_ingest_path(dev):
    """Phase 10b: `data/ingest.ingest` on the card (target 144x192x160,
    normalize "znorm") of a raw B = 2 batch at BraTS's raw 240x240x155
    made from seed 0, against the port's CPU result within 1e-5 of
    scale; its time (CUDA events) and peak memory. It launches no kernel
    of the port (resize GEMMs and reductions)."""
    import numpy as np
    import torch

    from pulpo_tpu_torch.data.ingest import ingest

    raw = np.random.default_rng(0).gamma(2.0, 300.0, (2, *INGEST_RAW, 1)).astype(np.float32)
    t = time.perf_counter()
    ref = ingest(raw, target=INGEST_TARGET, normalize="znorm", device="cpu")
    cpu_s = time.perf_counter() - t
    x = torch.from_numpy(raw).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = ingest(x, target=INGEST_TARGET, normalize="znorm")
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    expect(read_counts(), {}, "ingest")
    if tuple(got.shape) != (2, *INGEST_TARGET, 1) or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"ingest: shape {tuple(got.shape)} or not finite")
    err = float((got.cpu() - ref).abs().max()) / float(ref.abs().max())
    if not err <= 1e-5:
        raise SystemExit(f"ingest: card vs CPU {err:.3e} of scale")
    ms = time_ms(lambda: ingest(x, target=INGEST_TARGET, normalize="znorm"), 1)
    bytes_moved = raw.nbytes + got.numel() * 4
    log(f"ingest: (2, {INGEST_RAW}) -> {tuple(got.shape)} znorm on the card {ms:.3f} ms (CUDA "
        f"events), {bytes_moved / (ms * 1e-3) / 1e9:.1f} GB/s of input and output, peak "
        f"{peak:.3f} GiB above the input; the CPU {cpu_s:.2f} s; card vs CPU {err:.2e} of "
        "scale (tolerance 1e-5)")
    return {"ms": ms, "peak_gib": peak, "err": err, "cpu_s": cpu_s}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_dp_world1(dev, cfg_kw, steps, plain_step_s):
    """Phase 10c: `make_dp_train_step` over NCCL at world size 1 against
    `make_train_step`, the flagship config at full width (B = 1), the
    same weights, batch and draws (`noise=`). With cuDNN deterministic,
    the DP gradients (`dp_compute_grads`) against the plain step's twice
    (its own run-to-run spread: #2's float32 atomics): the loss and the
    BatchNorm statistics must be equal bit for bit, the gradients no
    further from the plain step's than its second run is (twice that, or
    1e-5 relative L2). Then 1 + `steps` steps of each from the same
    state, timed, with exact launch counts of the DP steps."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.parallel import multihost
    from pulpo_tpu_torch.parallel.dp import make_dp_train_step, replicate_state
    from pulpo_tpu_torch.parallel.mesh import make_mesh
    from pulpo_tpu_torch.train import create_train_state, make_train_step
    from pulpo_tpu_torch.train.step import compute_grads, dp_compute_grads

    cfg = PULPoConfig(**cfg_kw, batch_size=1)
    t = time.perf_counter()
    multihost.initialize(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    init_s = time.perf_counter() - t
    try:
        backend = torch.distributed.get_backend()
        if dev.type == "cuda" and backend != "nccl":
            raise SystemExit(f"dp world 1: backend {backend}, not nccl")
        mesh = make_mesh(1)
        pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=1).get_pair(
            0, np.random.default_rng(1))
        batch = {k: torch.as_tensor(pair[k][None]).to(dev) for k in ("x", "y")}
        g = np.random.default_rng(7)
        noise = {l: torch.from_numpy(g.standard_normal((1, *cfg.level_sizes[l], cfg.zdim),
                                                       dtype=np.float32))
                 for l in range(cfg.latent_levels)}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            model = PULPoModel(cfg, device=dev)
            model.init(0)
            plain = [compute_grads(model, batch, noise=noise) for _ in range(2)]
            dp = dp_compute_grads(model, batch, mesh, noise=noise)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        (ref_g, ref_s, ref_m), (again_g, _, _), (dp_g, dp_s, dp_m) = plain[0], plain[1], dp
        spread = grad_spread(again_g, ref_g)[0]
        rel, worst, leaf = grad_spread(dp_g, ref_g)
        bit_equal = all(torch.equal(v, ref_g[n]) for n, v in dp_g.items())
        loss_equal = all(float(dp_m[k]) == float(ref_m[k]) for k in
                         ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"))
        stats_equal = all(torch.equal(v, ref_s[n]) for n, v in dp_s.items())
        log(f"dp world 1 ({backend}, init {init_s:.2f} s): losses "
            f"{'equal' if loss_equal else 'DIFFER'} (total {float(dp_m['total_loss'])!r} vs "
            f"{float(ref_m['total_loss'])!r}), BatchNorm statistics "
            f"{'equal' if stats_equal else 'DIFFER'}, gradients "
            f"{'bit-equal' if bit_equal else 'not bit-equal'}: {rel:.3e} from the plain step's "
            f"(relative L2; worst leaf {worst:.3e} of its scale, {leaf}), the plain step's "
            f"second run {spread:.3e} from its first")
        if not (loss_equal and stats_equal) or rel > max(2 * spread, 1e-5):
            raise SystemExit("dp world 1: the DP step differs from the plain step")
        del model, plain, dp, ref_g, again_g, dp_g
        torch.cuda.empty_cache()

        results = {}
        for name in ("plain", "dp"):
            model = PULPoModel(cfg, device=dev)
            state, tx = create_train_state(model, seed=0)
            if name == "dp":
                replicate_state(state, mesh)
                step = make_dp_train_step(model, tx, mesh)
                reset_counts()
            else:
                step = make_train_step(model, tx)
            times, losses = [], []
            for i in range(1 + steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, batch, noise=noise)
                torch.cuda.synchronize()
                if i:
                    times.append(time.perf_counter() - t)
                losses.append(float(metrics["total_loss"]))
                if not math.isfinite(losses[-1]) or state.nan_flag:
                    raise SystemExit(f"dp world 1: {name} step {i} loss {losses[-1]}")
            if name == "dp":
                counts = read_counts()
            results[name] = (statistics.median(times), losses,
                             {n: p.detach().clone() for n, p in model.module.named_parameters()})
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        multihost.shutdown()
    expect(counts, step_launches(cfg, 1 + steps), f"dp world 1 ({1 + steps} steps)")
    params_rel = grad_spread(results["dp"][2], results["plain"][2])[0]
    log(f"dp world 1 steps: DP {results['dp'][0]:.3f} s, plain {results['plain'][0]:.3f} s "
        f"(median of {steps}; phase 5b's step {plain_step_s:.3f} s); total losses DP "
        f"{results['dp'][1]}, plain {results['plain'][1]}; parameters after "
        f"{1 + steps} steps {params_rel:.3e} apart (relative L2)")
    return counts, {"dp_step_s": results["dp"][0], "plain_step_s": results["plain"][0],
                    "bit_equal": bit_equal, "rel": rel, "spread": spread}


def run_train_cli_dp(dev, run_root):
    """Phase 10d: `train_cli --data_parallel 2` as two processes sharing
    the one card (torchrun; gloo on CUDA tensors, named with
    `--dist_backend gloo`: NCCL refuses two ranks on one device), on an
    in-memory BraTS store at 64x64x64 (3 levels, n0 32, f32, global
    batch 2), 2 steps and one validation. Checks: finite validation
    losses, the two ranks' states equal bit for bit, one run directory
    written by rank 0 alone (one metrics line a logged step), `latest`
    equal to the ranks' states and reloading bit for bit, exact launch
    counts on each rank."""
    import torch

    from pulpo_tpu_torch.train.checkpoint import CheckpointManager, read_checkpoint
    from pulpo_tpu_torch.train.metrics import read_metrics

    out = run_root / "ranks"
    out.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DP_WORLD), os.path.abspath(__file__), "--dp-worker", str(out),
           str(run_root / "runs"), "gpu" if dev.type == "cuda" else "cpu"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"train_cli dp: torchrun rc {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    ranks = [torch.load(out / f"rank_{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    run_dir = pathlib.Path(ranks[0]["run_dir"])
    if any(pathlib.Path(r["run_dir"]) != run_dir for r in ranks):
        raise SystemExit(f"train_cli dp: run directories {[r['run_dir'] for r in ranks]}")
    versions = sorted(p for p in (run_root / "runs").glob("**/version_*") if p.is_dir())
    if versions != [run_dir]:
        raise SystemExit(f"train_cli dp: run directories on disk {versions}")
    writers = [r["writer"] for r in ranks]
    if writers != ["MetricWriter"] + ["_Silent"] * (DP_WORLD - 1):
        raise SystemExit(f"train_cli dp: writers by rank {writers}")
    for r in ranks[1:]:
        equal_payloads(r["payload"], ranks[0]["payload"], f"train_cli dp: rank {r['rank']} vs 0")
    cfg = CheckpointManager.load_config(run_dir)
    if (cfg.data_parallel, cfg.batch_size, tuple(cfg.input_size)) != (DP_WORLD, DP_WORLD,
                                                                      DP_SIZE):
        raise SystemExit(f"train_cli dp: config {cfg.data_parallel} {cfg.batch_size} "
                         f"{cfg.input_size}")
    rows = read_metrics(run_dir)
    if [r["step"] for r in rows] != [DP_STEPS] or any(r["steps"] != DP_STEPS for r in ranks):
        raise SystemExit(f"train_cli dp: logged steps {[r['step'] for r in rows]}")
    val = {k: rows[0][f"val/{k}"] for k in ("kl_loss", "reconstruction_loss",
                                            "regularization_loss", "total_loss")}
    if not all(math.isfinite(v) for v in val.values()) or ranks[0]["payload"]["nan_flag"]:
        raise SystemExit(f"train_cli dp: validation losses {val}")
    equal_payloads(read_checkpoint(run_dir, "latest"), ranks[0]["payload"],
                   "train_cli dp: latest vs the ranks' state")
    check_reload(run_dir, None, cfg, dev, "train_cli dp")
    per_rank = step_launches(cfg, DP_STEPS, ranks[0]["validations"] * -(-DP_SPLITS[1] // DP_WORLD))
    for r in ranks:
        expect(r["counts"], per_rank, f"train_cli dp rank {r['rank']}")
    counts = add_counts(*(r["counts"] for r in ranks))
    log(f"train_cli dp: {DP_WORLD} processes on one card (gloo), {cfg.input_size} levels "
        f"{cfg.total_levels}/{cfg.latent_levels} n0 {cfg.n0} {cfg.compute_dtype}, global batch "
        f"{cfg.batch_size}, {DP_STEPS} steps and {ranks[0]['validations']} validation in "
        f"{wall:.1f} s (torchrun, start-up included); validation losses {val}; the ranks' "
        "states equal bit for bit, rank 0 alone wrote the run, latest reloads bit for bit")
    return counts, {"wall_s": wall}


def dp_worker(out_dir, run_root, accelerator="gpu") -> int:
    """One rank of phase 10d, under torchrun: `train_cli --data_parallel
    2 --dist_backend gloo` on an in-memory BraTS store, then its state,
    kernel launch counts and writer saved to `out_dir/rank_<r>.pt`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from pulpo_tpu_torch import train_cli
    from pulpo_tpu_torch.train import loop
    from pulpo_tpu_torch.train.checkpoint import state_payload

    key = "memory://BraTS-dp.h5"
    stores = {key: brats_store(DP_SIZE, DP_SPLITS, seed=91)}
    fit, kept = loop.Trainer.fit, {}

    def recorded(trainer, *args, **kw):
        state = fit(trainer, *args, **kw)
        kept.update(state=state, rank=trainer.rank, writer=type(trainer.writer).__name__,
                    validations=len(trainer.times["validate"]),
                    steps=len(trainer.times["step"]))
        return state

    loop.Trainer.fit = recorded
    reset_counts()
    with memory_stores(stores):
        run_dir = train_cli.main([
            "--data_path", key, "--max_steps", str(DP_STEPS), "--skip_eval",
            "--run_dir", str(run_root), "--accelerator", accelerator, "--data_parallel",
            str(DP_WORLD), "--dist_backend", "gloo", "--batch_size", str(DP_WORLD),
            "--total_levels", "3", "--latent_levels", "2"])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    state = kept.pop("state")
    torch.save({"payload": state_payload(state), "counts": read_counts(),
                "run_dir": str(run_dir), **kept},
               pathlib.Path(out_dir) / f"rank_{kept['rank']}.pt")
    return 0


# ----------------------------------------------------------------------
# phases 11-11c: the depth-sharded forward and step, the output-channel
# split (parallel/spatial.py, parallel/tp.py)
# ----------------------------------------------------------------------

SPACE = 2                  # ranks of the space axis (and of the model axis): sharing the card
SPATIAL_FWD_REL = 1e-3     # of scale: the floor of the sharded forward's distance
SPATIAL_LOSS_REL = 1e-5    # relative: the floor of the sharded step's losses' distance
STEP_DTYPES = ("bfloat16", "float32")  # 11b: the flagship's step, and the same network in f32
TP_REL = 1e-2              # of scale: the split forward against the replicated one
SPATIAL_F32_REL = 1e-5     # of scale: the floor of the f32 sharded forward's distance (11a)
# 11d: the OASIS configuration's segmentation (Dice) step and the
# flagship step with the jdet regularizer: (name, keywords over the
# phase's config, dtype, batch rows)
DICE_KW = {k: OASIS[k] for k in ("segs", "recon_loss", "dice_factor")}
SEG_STEPS = (("dice bfloat16 B=2", DICE_KW, "bfloat16", 2),
             ("dice float32 B=1", DICE_KW, "float32", 1),
             ("jdet float32 B=1", dict(regularizer="jdet"), "float32", 1))
PLAIN_SEG_PEAK_GIB = 38.20  # phase 8b's unsharded B = 2 segmentation step (PERF.md §5, PR 11)
LOSS_KEYS = ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss")
# 11e: 11d's bf16 B = 2 Dice step under remat, held to that step sharded
REMAT_OF = SEG_STEPS[0]
REMAT_STEPS = tuple((f"{REMAT_OF[0]} {k}", {**REMAT_OF[1], **kw}, *REMAT_OF[2:])
                    for k, kw in (("remat", {"remat": True}),
                                  ("remat_down=(0,)", {"remat_down": (0,)})))
# phase 8b's unsharded B = 2 segmentation step's peaks (PERF.md §5, PRs 11-13)
REMAT_PEAK_GIB = {"remat": 21.79, "remat_down=(0,)": 25.63}
# 11f: the flagship at full_res (the channels-first eval decode), B = 1
FULLRES_FORWARDS = tuple(f"fullres forward {d}" for d in STEP_DTYPES)
FULLRES_STEP = "fullres step float32"
# 11g: `flagship-2d` sharded along H (its 160-, 80-, 40- and 20-line
# levels split in two, the 10-line coarsest replicated): the forward in
# bf16 and f32, the step at B = 1 in bf16 and f32 and the 2D OASIS
# (Dice) step in bf16 at B = 2: (name, keywords over the phase's config,
# dtype, batch rows)
SPATIAL_2D_FORWARDS = tuple(f"2d forward {d}" for d in STEP_DTYPES)
SPATIAL_2D_STEPS = (("2d step bfloat16 B=1", {}, "bfloat16", 1),
                    ("2d step float32 B=1", {}, "float32", 1),
                    ("2d dice bfloat16 B=2", DICE_KW, "bfloat16", 2))


def check_slab_kernels(dev, cfg, checks, seg_cfg):
    """Phase 11: the slab launches of the depth-sharded model at the
    flagship's shapes, each split SPACE ways: the warp (#4) and its
    df-cotangent (#6) at C = 1 of the level-0 df (the input size) over the
    image and of each split latent level's df over its pooled image, and
    at C = 36 over each split level's one-hot map of the segmentation
    step (`seg_cfg`'s `transform_segmentation` shapes: 160x192x224 in
    slabs of 80, 40x48x56 of 20, 20x24x28 of 10), the squaring step (#1,
    with the first step's 1/2**nsteps scale and without) at each split
    latent level, and the full_res decode's channels-first slabs: the CF
    squaring step (#3, with and without the scale) on a B = 1 field at
    each split latent level, the CF image warp (#8) of the image by the
    4-row stacked dfs of a B = 1 forward at the input size (slabs of 80):
    each slab bit-equal to the matching planes of the whole
    launch and to the plain version at its offset (the plain df-cotangent
    adds a corner's channels in order, as the kernel's bodies do); the
    step backward's (#2) share of each slab within 1e-5 of scale of the
    whole backward of that slab's cotangent (float32 atomics), the
    shares' sum of the whole backward. Each slab launch's device time
    (CUDA-graph replay) beside the whole launch's, and the body each C =
    36 slab launch and each #8 slab launch took. Then the fused eval kernels on a slab with the
    halo the sharded forward gives them (the conv chain #13 3 planes at
    the input size, the posterior head #11 4 and the velocity head #10 2
    at latent level 0; bf16, cropped): each against the matching planes
    of the whole launch, which they equal where a voxel's arithmetic
    does not depend on where its launch starts (held to BF16_CHAIN_REL
    of scale; the error is logged). Returns ({kernel: {case: {"ms",
    "whole_ms"}}}, {C = 36 or CF case: {(kernel, body): launches}})."""
    import torch

    from pulpo_tpu_torch.kernels import conv_chain, pos_head, squaring, vel_head, warp
    from pulpo_tpu_torch.parallel.spatial import splits

    g = torch.Generator().manual_seed(111)
    rand = lambda *shape: torch.rand(shape, generator=g).to(dev)
    normal = lambda *shape: torch.randn(shape, generator=g).to(dev)
    parts = lambda depth: [(r * (depth // SPACE), depth // SPACE) for r in range(SPACE)]
    card = dev.type == "cuda"
    times = {"warp": {}, "warp_dfgrad": {}, "squaring": {}, "squaring_bwd": {},
             "squaring_cf": {}, "warp_cf": {}}
    bodies = {}
    fmt = lambda s: "x".join(map(str, s))

    def timed_slab(kernel, case, slab_fn, whole_fn):
        if card:
            times[kernel][case] = {"ms": graph_ms(slab_fn, 5), "whole_ms": graph_ms(whole_fn, 5)}

    warps = [(cfg.input_size, rand(1, *cfg.input_size, 1))]
    warps += [(cfg.level_sizes[l], rand(1, *cfg.level_sizes[l], 1))
              for l in range(1, cfg.latent_levels)]
    warps += [(dshape[1:-1], onehot_volume(mshape, 400 + i, dev))
              for i, (mshape, dshape) in enumerate(seg_shapes(seg_cfg))]
    for size, moving in warps:
        if not splits(size[0], SPACE):
            continue
        c = moving.shape[-1]
        df, cot = smooth_field(1, size, 3.0, 112, dev), normal(1, *size, c)
        whole, whole_grad = warp.warp(moving, df), warp.warp_dfgrad(moving, df, cot)
        for z0, per in parts(size[0]):
            sl = slice(z0, z0 + per)
            d, gc = df[:, sl].contiguous(), cot[:, sl].contiguous()
            case = f"C={c} slab {z0}+{per} of {fmt(size)}"
            warp.slab_bodies.clear()
            got = warp.warp(moving, d, z0, size[0])
            checks.record("warp", f"{case} vs whole", got, whole[:, sl], 0.0)
            checks.record("warp", f"{case} vs plain", got,
                          warp.warp_plain(moving, d, z0, size[0]), 0.0)
            del got
            got = warp.warp_dfgrad(moving, d, gc, z0, size[0])
            checks.record("warp_dfgrad", f"{case} vs whole", got, whole_grad[:, sl], 0.0)
            checks.record("warp_dfgrad", f"{case} vs plain", got,
                          warp.warp_dfgrad_plain(moving, d, gc, z0, size[0]), 0.0)
            del got
            if c > 1:
                bodies[case] = dict(warp.slab_bodies)
                log(f"slab bodies {case}: {bodies[case]}")
            timed_slab("warp", case, lambda: warp.warp(moving, d, z0, size[0]),
                       lambda: warp.warp(moving, df))
            timed_slab("warp_dfgrad", case, lambda: warp.warp_dfgrad(moving, d, gc, z0, size[0]),
                       lambda: warp.warp_dfgrad(moving, df, cot))
        del whole, whole_grad, df, cot
        if card:
            torch.cuda.empty_cache()
    del warps
    for l, size in cfg.level_sizes.items():
        if not splits(size[0], SPACE):
            continue
        v, cot = smooth_field(1, size, 2.0, 113 + l, dev), normal(1, *size, 3)
        for scale in (1.0 / 2**cfg.nsteps, 1.0):
            whole = squaring.squaring_step(v, scale=scale)
            for z0, per in parts(size[0]):
                sl = slice(z0, z0 + per)
                case = f"slab {z0}+{per} of {size} x{scale:g}"
                got = squaring.squaring_step(v, scale=scale, z0=z0, depth=per)
                checks.record("squaring", f"{case} vs whole", got, whole[:, sl], 0.0)
                checks.record("squaring", f"{case} vs plain", got,
                              squaring.squaring_step_plain(v * scale, z0, per), 0.0)
                timed_slab("squaring", f"slab {z0}+{per} of {fmt(size)} x{scale:g}",
                           lambda: squaring.squaring_step(v, scale=scale, z0=z0, depth=per),
                           lambda: squaring.squaring_step(v, scale=scale))
        ref = squaring.squaring_step_bwd(v, cot)
        total = torch.zeros_like(ref)
        for z0, per in parts(size[0]):
            sl = slice(z0, z0 + per)
            gs = cot[:, sl].contiguous()
            share = squaring.squaring_step_bwd(v, gs, z0)
            masked = torch.zeros_like(cot)
            masked[:, sl] = cot[:, sl]
            slab_ref = squaring.squaring_step_bwd(v, masked)
            checks.record("squaring_bwd", f"share {z0}+{per} of {size}", share, slab_ref,
                          scaled(slab_ref, 1e-5))
            total += share
            timed_slab("squaring_bwd", f"share {z0}+{per} of {fmt(size)}",
                       lambda: squaring.squaring_step_bwd(v, gs, z0),
                       lambda: squaring.squaring_step_bwd(v, cot))
        checks.record("squaring_bwd", f"shares' sum at {size}", total, ref, scaled(ref, 1e-5))
    # the full_res decode's channels-first slabs: #3 on a B = 1 forward's
    # field at each split latent level, #8 of the image by the stacked dfs
    # of its levels at the input size
    cf = lambda t: t.permute(0, 4, 1, 2, 3).contiguous()
    for l, size in cfg.level_sizes.items():
        if not splits(size[0], SPACE):
            continue
        v = cf(smooth_field(1, size, 2.0, 117 + l, dev))
        for scale in (1.0 / 2**cfg.nsteps, 1.0):
            whole = squaring.squaring_step_cf(v, scale=scale)
            for z0, per in parts(size[0]):
                case = f"CF slab {z0}+{per} of {fmt(size)} x{scale:g}"
                got = squaring.squaring_step_cf(v, scale=scale, z0=z0, depth=per)
                checks.record("squaring_cf", f"{case} vs whole", got, whole[:, :, z0:z0 + per], 0.0)
                checks.record("squaring_cf", f"{case} vs plain", got,
                              squaring.squaring_step_cf_plain(v * scale, z0, per), 0.0)
                timed_slab("squaring_cf", case,
                           lambda: squaring.squaring_step_cf(v, scale=scale, z0=z0, depth=per),
                           lambda: squaring.squaring_step_cf(v, scale=scale))
        del v, whole, got
    size, rows = cfg.input_size, cfg.latent_levels
    img = rand(1, 1, *size)
    df = cf(smooth_field(rows, size, 3.0, 118, dev))
    whole = warp.warp_cf(img, df)
    for z0, per in parts(size[0]):
        d = df[:, :, z0:z0 + per].contiguous()
        case = f"CF C=1 {rows} rows slab {z0}+{per} of {fmt(size)}"
        warp.slab_bodies.clear()
        got = warp.warp_cf(img, d, z0, size[0])
        bodies[case] = dict(warp.slab_bodies)
        log(f"slab bodies {case}: {bodies[case]}")
        checks.record("warp_cf", f"{case} vs whole", got, whole[:, :, z0:z0 + per], 0.0)
        checks.record("warp_cf", f"{case} vs plain", got, warp.warp_cf_plain(img, d, z0, size[0]),
                      0.0)
        del got
        timed_slab("warp_cf", case, lambda: warp.warp_cf(img, d, z0, size[0]),
                   lambda: warp.warp_cf(img, df))
    del img, df, whole, d
    if card:
        torch.cuda.empty_cache()
    for kernel, cases in times.items():
        for case, r in cases.items():
            log(f"time slab {kernel} {case}: {r['ms']:.5f} ms, the whole launch "
                f"{r['whole_ms']:.5f} ms")

    bf = torch.bfloat16
    level0 = cfg.level_sizes[0]
    widths = pos_head_widths(cfg, 0)
    stages = chain_stages((2, cfg.n0, cfg.n0, cfg.n0), 114, dev)
    p, hp = pos_head_params(widths, cfg.zdim, 115, dev), head_params(cfg.zdim, cfg.n0, 116, dev)
    fused = [
        ("conv_chain", 3, lambda x: conv_chain.conv_chain(x[0], stages),
         [rand(1, *cfg.input_size, 2).to(bf)]),
        ("pos_head", 4, lambda x: pos_head.posterior_head(x[0], x[1], p)[0],
         [normal(1, *level0, widths[0]).to(bf), normal(1, *level0, widths[2]).to(bf)]),
        ("vel_head", 2, lambda x: vel_head.velocity_head(x[0], hp),
         [normal(1, *level0, cfg.zdim).to(bf)])]
    for name, h, fn, args in fused:
        whole = fn(args)
        depth = args[0].shape[1]
        for z0, per in parts(depth):
            lo, hi = min(h, z0), min(h, depth - z0 - per)
            got = fn([a[:, z0 - lo:z0 + per + hi].contiguous() for a in args])[:, lo:lo + per]
            checks.record(name, f"slab {z0}+{per} on a {h}-plane halo vs whole",
                          got, whole[:, z0:z0 + per], scaled(whole, BF16_CHAIN_REL))
    return times, bodies


def check_slab_kernels_2d(dev, cfg, checks, seg_cfg, rows=2):
    """Phase 11g's kernel checks: the 2D slab launches of the sharded
    `flagship-2d` at its shapes, each split SPACE ways along H: the 2D
    squaring step (#1's 2D arm) on a `rows`-row field at each size that
    splits (160x192 in slabs of 80, 80x96 of 40, 40x48 of 20, 20x24 of
    10), with the first step's 1/2**nsteps scale and without; the 2D
    warp at C = 1 of the level-0 df (the input size) over the image and
    of each split latent level's df over its pooled image, and at C = 36
    over each split level's one-hot map of the 2D Dice step (`seg_cfg`'s
    `transform_segmentation` shapes, `rows` rows). Each slab bit-equal to
    the matching lines of the whole launch and to the plain version at
    its offset; each slab launch's device time (CUDA-graph replay)
    beside the whole launch's, and the body each 2D warp slab took.
    Returns ({kernel: {case: {"ms", "whole_ms"}}}, {case: {(kernel,
    body): launches}})."""
    import torch

    from pulpo_tpu_torch.kernels import squaring, warp
    from pulpo_tpu_torch.parallel.spatial import splits

    g = torch.Generator().manual_seed(211)
    parts = lambda h: [(r * (h // SPACE), h // SPACE) for r in range(SPACE)]
    fmt = lambda s: "x".join(map(str, s))
    card = dev.type == "cuda"
    times = {"squaring_2d": {}, "warp_2d": {}}
    bodies = {}

    def timed_slab(kernel, case, slab_fn, whole_fn):
        if card:
            times[kernel][case] = {"ms": graph_ms(slab_fn, 5), "whole_ms": graph_ms(whole_fn, 5)}

    for i, size in enumerate((cfg.input_size, *cfg.level_sizes.values())):
        if not splits(size[0], SPACE):
            continue
        v = smooth_field(rows, size, 2.0, 212 + i, dev, channels=2)
        for scale in (1.0 / 2**cfg.nsteps, 1.0):
            whole = squaring.squaring_step(v, scale=scale)
            for z0, per in parts(size[0]):
                case = f"slab {z0}+{per} of {fmt(size)} x{scale:g}"
                got = squaring.squaring_step(v, scale=scale, z0=z0, depth=per)
                checks.record("squaring_2d", f"{case} vs whole", got, whole[:, z0:z0 + per], 0.0)
                checks.record("squaring_2d", f"{case} vs plain", got,
                              squaring.squaring_step_plain(v * scale, z0, per), 0.0)
                timed_slab("squaring_2d", case,
                           lambda: squaring.squaring_step(v, scale=scale, z0=z0, depth=per),
                           lambda: squaring.squaring_step(v, scale=scale))
        del v, whole, got
    warps = [(cfg.input_size, torch.rand((1, *cfg.input_size, 1), generator=g).to(dev))]
    warps += [(cfg.level_sizes[l], torch.rand((1, *cfg.level_sizes[l], 1), generator=g).to(dev))
              for l in range(1, cfg.latent_levels)]
    warps += [(dshape[1:-1], onehot_volume(mshape, 220 + i, dev))
              for i, (mshape, dshape) in enumerate(seg_shapes(seg_cfg, rows))]
    for i, (size, moving) in enumerate(warps):
        if not splits(size[0], SPACE):
            continue
        c = moving.shape[-1]
        df = smooth_field(moving.shape[0] if c > 1 else rows, size, 3.0, 230 + i, dev,
                          channels=2)
        whole = warp.warp(moving, df)
        for z0, per in parts(size[0]):
            d = df[:, z0:z0 + per].contiguous()
            case = f"C={c} {df.shape[0]} rows slab {z0}+{per} of {fmt(size)}"
            warp.slab_bodies.clear()
            got = warp.warp(moving, d, z0, size[0])
            bodies[case] = dict(warp.slab_bodies)
            log(f"slab bodies 2D {case}: {bodies[case]}")
            checks.record("warp_2d", f"{case} vs whole", got, whole[:, z0:z0 + per], 0.0)
            checks.record("warp_2d", f"{case} vs plain", got,
                          warp.warp_plain(moving, d, z0, size[0]), 0.0)
            del got
            timed_slab("warp_2d", case, lambda: warp.warp(moving, d, z0, size[0]),
                       lambda: warp.warp(moving, df))
        del whole, df
    del warps
    if card:
        torch.cuda.empty_cache()
    for kernel, cases in times.items():
        for case, r in cases.items():
            log(f"time slab {kernel} {case}: {r['ms']:.5f} ms, the whole launch "
                f"{r['whole_ms']:.5f} ms")
    return times, bodies


def fullres_forward_launches(cfg):
    """Launches of one full_res eval forward on the channels-first decode:
    a decode (`serving_launches`) and its encode's conv chains."""
    return add_counts(serving_launches(cfg, 1, 0), eval_launches(cfg, 1, 0))


def spatial_inputs(cfg, dev, rows=1, segs=False):
    """Phases 11a-11f's batch (`rows` of phase 10c's synthetic pairs; with
    `segs`, a 36-class one-hot map of smooth labels for each volume, as
    phase 8b's batch holds) and the step's draws, the same in every
    process."""
    import numpy as np
    import torch

    from pulpo_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(shape=cfg.input_size, n=2 * rows, seed=1)
    pairs = [ds.get_pair(i, np.random.default_rng(1 + i)) for i in range(rows)]
    batch = {k: torch.as_tensor(np.stack([p[k] for p in pairs])).to(dev) for k in ("x", "y")}
    if segs:
        for i, k in enumerate(("seg_x", "seg_y")):
            batch[k] = onehot_volume((rows, *cfg.input_size, SEG_CLASSES), 500 + i, dev)
    g = np.random.default_rng(7)
    noise = {l: torch.from_numpy(g.standard_normal((rows, *cfg.level_sizes[l], cfg.zdim),
                                                   dtype=np.float32))
             for l in range(cfg.latent_levels)}
    return batch, noise


def seg_step_cfg(cfg_kw, kw, dtype, rows):
    """Phase 11d's configuration: the phase's config with a SEG_STEPS
    case's keywords, dtype and batch."""
    from pulpo_tpu_torch import PULPoConfig

    return PULPoConfig(**{**cfg_kw, **kw, "compute_dtype": dtype, "batch_size": rows})


def timed(fn):
    """(result, host seconds) of fn() between two synchronizes (of the
    card, where there is one: the CPU rehearsal has none)."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def peak_of(fn, before=None):
    """(result, host seconds, peak GiB above the memory held before) of a
    second call of fn (the first warms the kernels and cuDNN; `before` is
    called between the two); 0 GiB without a card."""
    import torch

    fn()
    if before is not None:
        before()
    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out, seconds = timed(fn)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if card else 0.0
    return out, seconds, peak


def tp_launches(cfg):
    """Launches of one `predict_deterministic` under the output-channel
    split: each eval unit alone on the conv-unit kernel (3 a down block,
    2 an up block, a merge block and a velocity head), the integrations
    and warps as unsplit."""
    K = cfg.latent_levels
    units = 3 * cfg.total_levels + 2 * (K - 1) * 2 + 2 * K
    return {"conv_chain": units, "warp": K, "squaring": cfg.nsteps * K}


def step_reference(cfg, batch, noise, dev, on_host=False):
    """The unsharded step a sharded one is held to, on the card: its
    gradients (on the host) and losses, again (its run-to-run distance)
    and on x and y moved by one float32 ulp (its distance under a float32
    rounding), its time and peak (cuDNN deterministic). With `on_host`,
    also the same step on the CPU (the plain versions: every sum in
    another order) as a yardstick (`held_step`), "cpu"."""
    import torch

    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = PULPoModel(cfg, device=dev)
        model.init(0)
        (grads, _, metrics), seconds, peak = peak_of(
            lambda: compute_grads(model, batch, noise=noise))
        grads = {n: v.cpu() for n, v in grads.items()}
        again, _, again_m = compute_grads(model, batch, noise=noise)
        again = {n: v.cpu() for n, v in again.items()}
        moved = {k: v * (1 + 2.0**-23) if k in ("x", "y") else v for k, v in batch.items()}
        ulp, _, ulp_m = compute_grads(model, moved, noise=noise)
        ulp = {n: v.cpu() for n, v in ulp.items()}
        sticks = {}
        if on_host:
            host = PULPoModel(cfg, device="cpu")
            host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            other, _, other_m = compute_grads(
                host, {k: v.cpu() for k, v in batch.items()},
                noise={l: v.cpu() for l, v in noise.items()})
            sticks["cpu"] = (other, other_m)
            del host
        del model, moved
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    loss = lambda m: {k: float(m[k]) for k in LOSS_KEYS}
    out = {"s": seconds, "peak": peak, "grads": grads, "losses": loss(metrics),
           "again": loss(again_m), "ulp": loss(ulp_m), "rr": grad_spread(again, grads)[0],
           "moved": grad_spread(ulp, grads)[0]}
    out["yardsticks"] = {k: yardstick(out, g, loss(m)) for k, (g, m) in sticks.items()}
    return out


def yardstick(ref, grads, losses):
    """How far another valid computation of `ref`'s step is from it: the
    gradients' relative L2 distance and each loss's absolute one."""
    return {"grad": grad_spread(grads, ref["grads"])[0],
            "losses": {k: abs(losses[k] - ref["losses"][k]) for k in LOSS_KEYS}}


def forward_reference(model, batch):
    """The unsharded deterministic forward a sharded one is held to: its
    level-0 final df and warped image (on the host), its time and peak,
    and its distance (max-abs of scale) on inputs moved by one float32
    ulp."""
    outs, s, peak = peak_of(lambda: model.apply_eval(batch["x"], batch["y"],
                                                     deterministic=True))
    fwd = {"s": s, "peak": peak, "df": outs[6][0].cpu(), "warped": outs[7][0].cpu()}
    del outs
    moved = {k: v * (1 + 2.0**-23) for k, v in batch.items()}
    outs = model.apply_eval(moved["x"], moved["y"], deterministic=True)
    fwd["moved"] = {k: float((o[0].cpu() - fwd[k]).abs().max()) / float(fwd[k].abs().max())
                    for k, o in (("df", outs[6]), ("warped", outs[7]))}
    return fwd


def spatial_references(dev, cfg, cfg_kw):
    """The unsharded runs phases 11a-11f are held to, on the card: the
    deterministic forward's level-0 final df and warped image, in the
    flagship's bf16 and in f32, at level_res and at full_res (11f), each
    also on inputs moved by one float32 ulp (its distance under a float32
    rounding), and `predict_deterministic`'s outputs; for each of
    STEP_DTYPES the step, the f32 full_res step and for each of SEG_STEPS
    the segmentation or jdet step (`step_reference`); each with its time
    and peak. Every tensor the ranks are compared with is on the host,
    and the card's cache is emptied, before the ranks start."""
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel

    batch, noise = spatial_inputs(cfg, dev)
    out = {}
    forward = lambda model: forward_reference(model, batch)
    fcfg = PULPoConfig(**{**cfg_kw, **FULLRES_KW}, batch_size=1)
    for dtype, fname in zip(STEP_DTYPES, FULLRES_FORWARDS):
        model = PULPoModel(cfg.replace(compute_dtype=dtype), device=dev)
        model.init(0)
        out[f"forward {dtype}"] = forward(model)
        if dtype == cfg.compute_dtype:
            (tp_out, out["tp_s"], out["tp_peak"]) = peak_of(
                lambda: model.predict_deterministic(batch["x"], batch["y"]))
            out["tp"] = tuple({l: v.cpu() for l, v in d.items()} for d in tp_out)
            del tp_out
        model = PULPoModel(fcfg.replace(compute_dtype=dtype), device=dev)
        model.init(0)
        out[fname] = forward(model)
        del model
    for dtype in STEP_DTYPES:
        out[f"step {dtype}"] = step_reference(cfg.replace(compute_dtype=dtype), batch, noise, dev)
    out[FULLRES_STEP] = step_reference(fcfg.replace(compute_dtype="float32"), batch, noise, dev)
    del batch
    for name, kw, dtype, rows in SEG_STEPS:
        scfg = seg_step_cfg(cfg_kw, kw, dtype, rows)
        sbatch, snoise = spatial_inputs(scfg, dev, rows, segs=scfg.segs)
        out[name] = step_reference(scfg, sbatch, snoise, dev)
        del sbatch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def spatial_worker(out_dir, accelerator, cfg_json) -> int:
    """One rank of phases 11a-11f, under torchrun (SPACE ranks over gloo
    on the one card): the sharded forward (bf16 and f32, at level_res and
    at full_res) and step (each of STEP_DTYPES) at mesh (1, SPACE), the
    sharded segmentation and jdet steps (SEG_STEPS), the Dice step under
    remat (REMAT_STEPS), the f32 full_res step, then the split forward at
    model SPACE, each with its launch counts, time, peak and exchanges
    (and the body each slab launch of a warp and its df-cotangent took);
    rank 0 keeps the gradients, and of the step REMAT_STEPS are held to
    those of its first run too; writes `out_dir/rank_<r>.pt`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import warp
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.parallel import multihost, spatial, tp

    dev = torch.device("cuda" if accelerator == "gpu" else "cpu")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(device=dev, backend="gloo")
    try:
        rank = torch.distributed.get_rank()
        cfg_kw = json.loads(cfg_json)
        cfg = PULPoConfig(**cfg_kw, batch_size=1)
        batch, noise = spatial_inputs(cfg, dev)
        mesh = spatial.make_2d_mesh(1, SPACE)
        block = {k: spatial.shard_volume(v, mesh) for k, v in batch.items()}
        out = {"rank": rank}
        fresh = lambda: (reset_counts(), spatial.reset_traffic())
        bodies = lambda: {f"{k} {b}": n for (k, b), n in sorted(warp.slab_bodies.items())}

        def step_record(seconds, peak, metrics, grads):
            return {"s": seconds, "peak": peak, "counts": read_counts(),
                    "traffic": dict(spatial.traffic), "bodies": bodies(),
                    "losses": {k: float(metrics[k]) for k in LOSS_KEYS},
                    "grads": {n: v.cpu() for n, v in grads.items()} if rank == 0 else None}

        fcfg = PULPoConfig(**{**cfg_kw, **FULLRES_KW}, batch_size=1)
        forwards = [(f"forward {d}", cfg, d) for d in STEP_DTYPES]
        forwards += [(f, fcfg, d) for f, d in zip(FULLRES_FORWARDS, STEP_DTYPES)]
        for fname, fwd_cfg, dtype in forwards:
            fmodel = PULPoModel(fwd_cfg.replace(compute_dtype=dtype), device=dev)
            fmodel.init(0)
            fwd = spatial.make_spatial_forward(fmodel, mesh)
            (df, warped), seconds, peak = peak_of(lambda: fwd(block["x"], block["y"]), fresh)
            out[fname] = {
                "df": df.cpu(), "warped": warped.cpu(), "s": seconds, "peak": peak,
                "counts": read_counts(), "traffic": dict(spatial.traffic), "bodies": bodies()}
            del df, warped, fmodel
        torch.backends.cudnn.deterministic = True
        for dtype in STEP_DTYPES:
            smodel = PULPoModel(cfg.replace(compute_dtype=dtype), device=dev)
            smodel.init(0)
            compute = lambda: spatial.spatial_compute_grads(smodel, block, mesh, noise=noise)
            (grads, _, metrics), seconds, peak = peak_of(compute, fresh)
            out[f"step {dtype}"] = step_record(seconds, peak, metrics, grads)
            del smodel, grads, metrics
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        for name, kw, dtype, rows in (*SEG_STEPS, *REMAT_STEPS):
            scfg = seg_step_cfg(cfg_kw, kw, dtype, rows)
            sbatch, snoise = spatial_inputs(scfg, dev, rows, segs=scfg.segs)
            sblock = {k: spatial.shard_volume(v, mesh).contiguous() for k, v in sbatch.items()}
            del sbatch
            smodel = PULPoModel(scfg, device=dev)
            smodel.init(0)
            runs = []
            compute = lambda: runs.append(spatial.spatial_compute_grads(
                smodel, sblock, mesh, noise=snoise)) or runs[-1]
            (grads, _, metrics), seconds, peak = peak_of(compute, fresh)
            out[name] = step_record(seconds, peak, metrics, grads)
            if name == REMAT_OF[0] and rank == 0:  # its run-to-run spread (11e)
                out[name]["first_grads"] = {n: v.cpu() for n, v in runs[0][0].items()}
            del smodel, grads, metrics, sblock, runs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        smodel = PULPoModel(fcfg.replace(compute_dtype="float32"), device=dev)
        smodel.init(0)
        compute = lambda: spatial.spatial_compute_grads(smodel, block, mesh, noise=noise)
        (grads, _, metrics), seconds, peak = peak_of(compute, fresh)
        out[FULLRES_STEP] = step_record(seconds, peak, metrics, grads)
        del smodel, grads, metrics
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False

        model = PULPoModel(cfg, device=dev)
        model.init(0)
        tmesh = tp.make_model_mesh(SPACE)
        tp.shard_params(model, tmesh)
        with tp.sharded(tmesh):
            run = lambda: model.predict_deterministic(batch["x"], batch["y"])
            (warped, dfs), seconds, peak = peak_of(run, reset_counts)
        out["tp"] = {"s": seconds, "peak": peak, "counts": read_counts(),
                     "warped": {l: v.cpu() for l, v in warped.items()},
                     "dfs": {l: v.cpu() for l, v in dfs.items()}}
        torch.save(out, pathlib.Path(out_dir) / f"rank_{rank}.pt")
    finally:
        multihost.shutdown()
    return 0


def held_step(name, mine, theirs, dtype, failures):
    """Phases 11b and 11d: a sharded step's losses and gradients (rank 0's)
    against the unsharded step's in the same dtype. The sharded step
    reorders float32 sums (halo convs, slab partial losses and
    statistics, summed squaring cotangents), a perturbation of float32
    rounding's size, so it is held to twice the unsharded step's own
    distance under such perturbations: the larger of its run-to-run
    distance (#2's atomics) and its distance on inputs moved by one
    float32 ulp, and where `theirs` holds them (its "yardsticks": phase
    11g's), in f32 its distance from the same step on the CPU ("cpu"),
    in bf16 from its f32 twin ("f32": its own bf16 rounding error), for
    the gradients (relative L2, at least 1e-5) and, in
    bf16, each loss term (at least SPATIAL_LOSS_REL of it; the KL, which
    is computed in the compute dtype and whose slab partials each round
    to it, at least one ulp of that dtype; the total, the sum of its
    terms' allowances). In f32 each loss is held to SPATIAL_LOSS_REL of
    it, relative. Returns the step's record of distances."""
    import torch

    away = lambda a: {k: abs(a[k] - theirs["losses"][k]) for k in LOSS_KEYS}
    loss = away(mine["losses"])
    sticks = theirs.get("yardsticks", {})
    own = {k: max(away(theirs["again"])[k], away(theirs["ulp"])[k],
                  *(y["losses"][k] for y in sticks.values())) for k in LOSS_KEYS}
    if dtype == "float32":
        allowed = {k: SPATIAL_LOSS_REL * abs(theirs["losses"][k]) for k in LOSS_KEYS}
    else:
        floor = {"kl_loss": max(SPATIAL_LOSS_REL, float(torch.finfo(getattr(torch, dtype)).eps)),
                 "reconstruction_loss": SPATIAL_LOSS_REL,
                 "regularization_loss": SPATIAL_LOSS_REL}
        allowed = {k: max(2 * own[k], f * abs(theirs["losses"][k])) for k, f in floor.items()}
        allowed["total_loss"] = sum(allowed.values())
    grad, worst, leaf = grad_spread(mine["grads"], theirs["grads"])
    spread = max(theirs["rr"], theirs["moved"], *(y["grad"] for y in sticks.values()))
    log(f"spatial {name}: losses {mine['losses']}, the unsharded step's {theirs['losses']}: "
        f"{loss} apart (allowed {allowed}; the unsharded step's own {own}); gradients "
        f"{grad:.3e} (relative L2; worst leaf {worst:.3e} of its scale, {leaf}); the "
        f"unsharded step's run-to-run {theirs['rr']:.3e}, on inputs moved by one float32 "
        f"ulp {theirs['moved']:.3e}" + "".join(
            f", {k} {y['grad']:.3e} (losses {y['losses']})" for k, y in sticks.items()))
    if any(loss[k] > allowed[k] for k in LOSS_KEYS):
        failures.append(f"{name}: losses {loss} apart, allowed {allowed}")
    if not grad <= max(2 * spread, 1e-5):
        failures.append(f"{name}: gradients {grad:.3e} against {spread:.3e}")
    return {"loss_abs": loss, "own_loss_abs": own, "allowed": allowed,
            "losses": theirs["losses"], "grad_rel": grad, "worst": worst, "leaf": leaf,
            "rr": theirs["rr"], "moved": theirs["moved"],
            "yardsticks": {k: y["grad"] for k, y in sticks.items()}}


def run_spatial_paths(dev, run_root, cfg_kw=FLAGSHIP):
    """Phases 11a-11f: SPACE processes sharing the one card (torchrun,
    gloo on CUDA tensors: NCCL refuses two ranks on one device), the
    flagship at full width (160x192x224, n0 32, bf16, level_res, B = 1).
    11a: `make_spatial_forward` at mesh (data 1, space SPACE), in the
    flagship's bf16 and in f32, each rank's slab of the level-0 final df
    and warped image against the unsharded forward's planes in the same
    dtype, within twice the unsharded forward's own distance on inputs
    moved by one float32 ulp (max-abs of scale; at least SPATIAL_FWD_REL
    in bf16, SPATIAL_F32_REL in f32): cuDNN may take another algorithm
    on a slab with its halo, and a bf16 rounding that flips moves the
    output as such a move of the inputs does; the f32 forward shows
    whether the bf16 gap is rounding only. 11b: `spatial_compute_grads`
    (the step's gradients and metrics) in bf16 and in f32 against the
    unsharded step in the same dtype (`held_step`). 11d: the
    segmentation (Dice) step of the OASIS configuration (36 one-hot
    classes, dice_factor 50) in bf16 at B = 2 and in f32 at B = 1, and
    the flagship step with the jdet regularizer in f32 at B = 1, each
    against the unsharded step (`held_step`); each rank's peak beside
    the unsharded step's and phase 8b's PLAIN_SEG_PEAK_GIB, and the body
    each C = 36 slab launch took. 11e: the bf16 B = 2 Dice step under
    `remat=True` and under `remat_down=(0,)` against 11d's sharded step:
    the losses equal (the forward has no atomics) and the gradients no
    further from it (relative L2) than twice its own run-to-run distance
    (at least 1e-5); each rank's peak beside phase 8b's unsharded remat
    peaks and 11d's, its seconds, and the exchanged bytes with the
    recomputation's share. 11f: the flagship at full_res (the
    channels-first decode: slab launches of #3 and #8): the forward in
    f32 held as 11a's f32 and in bf16 logged beside its own one-ulp
    distance, and the f32 B = 1 full_res step against the unsharded one
    (`held_step`). 11c: the output-channel split at model SPACE against
    the replicated `predict_deterministic`, within TP_REL of scale. Exact
    launch counts on each rank (a sharded forward and step launch what
    the unsharded ones do, a remat step its checkpointed regions'
    kernels again; the split forward 35 unit launches); each rank's
    time, peak and exchanges beside the unsharded run's. Every check
    runs before any failure stops the phase."""
    import torch

    from pulpo_tpu_torch import PULPoConfig

    cfg = PULPoConfig(**cfg_kw, batch_size=1)
    fcfg = PULPoConfig(**{**cfg_kw, **FULLRES_KW}, batch_size=1)
    ref = spatial_references(dev, cfg, cfg_kw)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = run_root / "ranks"
    out.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(SPACE), os.path.abspath(__file__), "--spatial-worker", str(out),
           "gpu" if dev.type == "cuda" else "cpu", json.dumps(cfg_kw)]
    proc, wall = timed(lambda: subprocess.run(cmd, capture_output=True, text=True, timeout=900))
    if proc.returncode != 0:
        raise SystemExit(f"spatial paths: torchrun rc {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    ranks = [torch.load(out / f"rank_{r}.pt", weights_only=False) for r in range(SPACE)]
    per = cfg.input_size[0] // SPACE
    forwards = [*(f"forward {d}" for d in STEP_DTYPES), *FULLRES_FORWARDS]
    fwd_dtype = dict(zip(forwards, 2 * STEP_DTYPES))
    steps = [f"step {d}" for d in STEP_DTYPES]
    segs = [name for name, *_ in SEG_STEPS]
    remats = [name for name, *_ in REMAT_STEPS]
    phases = [*forwards, *steps, *segs, *remats, FULLRES_STEP, "tp"]
    failures = []
    errs = {f: {"df": 0.0, "warped": 0.0} for f in forwards}
    for r in ranks:
        sl = slice(r["rank"] * per, (r["rank"] + 1) * per)
        for fname in forwards:
            f, want_all = r[fname], ref[fname]
            for k in ("df", "warped"):
                want = want_all[k][:, sl].float()
                got = f[k].float()
                if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                    failures.append(f"{fname} rank {r['rank']}: {k} {tuple(got.shape)}")
                    continue
                diff = (got - want).abs()
                errs[fname][k] = max(errs[fname][k],
                                     float(diff.max()) / float(want_all[k].abs().max()))
                plane = int(diff.amax(dim=(0, 2, 3, 4)).argmax()) + sl.start
                log(f"spatial {fname} rank {r['rank']}: {k} {float(diff.max()):.3e} at most "
                    f"(plane {plane}), {float(diff.square().sum().sqrt() / want.square().sum().sqrt()):.3e} "
                    "relative L2")
        expected = [(f"forward {d}", decode_launches(cfg, 1, 1)) for d in STEP_DTYPES]
        expected += [(f, fullres_forward_launches(fcfg)) for f in FULLRES_FORWARDS]
        expected += [("tp", tp_launches(cfg))] + [(name, step_launches(cfg, 1)) for name in steps]
        for name, kw, dtype, rows in (*SEG_STEPS, *REMAT_STEPS):
            scfg = seg_step_cfg(cfg_kw, kw, dtype, rows)
            expected.append((name, add_counts(step_launches(scfg, 1, dice="dice" in kw.get(
                "recon_loss", ())), remat_launches(scfg, 1))))
        expected.append((FULLRES_STEP, step_launches(fcfg, 1)))
        for phase, want in expected:
            try:
                expect(r[phase]["counts"], want, f"spatial {phase} rank {r['rank']}")
            except SystemExit as e:
                failures.append(str(e))
    for fname in forwards:
        dtype, moved = fwd_dtype[fname], ref[fname]["moved"]
        floor = SPATIAL_FWD_REL if dtype == "bfloat16" else SPATIAL_F32_REL
        log(f"spatial {fname}: {errs[fname]} of scale from the unsharded forward; the unsharded "
            f"forward on inputs moved by one float32 ulp {moved}")
        if fname == FULLRES_FORWARDS[0]:
            continue  # 11f's bf16 forward is logged beside its own one-ulp distance
        if any(errs[fname][k] > max(2 * moved[k], floor) for k in errs[fname]):
            failures.append(f"{fname}: {errs[fname]} of scale from the unsharded forward (its "
                            f"own distance under a one-ulp move of the inputs {moved})")
    step_info = {}
    for name, dtype in [*zip(steps, STEP_DTYPES), *((n, d) for n, _, d, _ in SEG_STEPS),
                        (FULLRES_STEP, "float32")]:
        if any(r[name]["losses"] != ranks[0][name]["losses"] for r in ranks):
            failures.append(f"{name}: the ranks' losses differ")
        step_info[name] = held_step(name, ranks[0][name], ref[name], dtype, failures)
    plain = ranks[0][REMAT_OF[0]]
    remat_spread = grad_spread(plain["first_grads"], plain["grads"])[0]
    remat_info = {}
    for name in remats:
        mine = ranks[0][name]
        rel, worst, leaf = grad_spread(mine["grads"], plain["grads"])
        if any(r[name]["losses"] != plain["losses"] for r in ranks):
            failures.append(f"{name}: losses {mine['losses']}, the sharded plain step's "
                            f"{plain['losses']}")
        if not rel <= max(2 * remat_spread, 1e-5):
            failures.append(f"{name}: gradients {rel:.3e} from the sharded plain step's, its "
                            f"run-to-run {remat_spread:.3e}")
        knob = name[len(REMAT_OF[0]) + 1:]
        recomputed = sum(v[1] for k, v in mine["traffic"].items() if k.endswith("_recomputed"))
        total = sum(v[1] for v in mine["traffic"].values())
        remat_info[name] = {"grad_rel": rel, "worst": worst, "leaf": leaf,
                            "recomputed_bytes": recomputed, "bytes": total}
        log(f"spatial {name}: losses {'equal' if mine['losses'] == plain['losses'] else 'DIFFER'}"
            f" to the sharded plain step's; gradients {rel:.3e} from it (relative L2; worst leaf "
            f"{worst:.3e} of its scale, {leaf}), its run-to-run {remat_spread:.3e}; a rank's peak "
            + ", ".join(f"{r[name]['peak']:.3f}" for r in ranks) + f" GiB (the sharded plain "
            f"step's {plain['peak']:.3f}; phase 8b's unsharded {knob} {REMAT_PEAK_GIB[knob]} "
            f"GiB), {mine['s']:.3f} s a step a rank (plain {plain['s']:.3f} s); exchanged "
            f"{total / 1e6:.1f} MB, {recomputed / 1e6:.1f} MB of it recomputed")
    tp_err = 0.0
    for i, key in enumerate(("warped", "dfs")):
        for l, want in ref["tp"][i].items():
            got = ranks[0]["tp"][key][l].float()
            if not bool(torch.isfinite(got).all()):
                failures.append(f"tp forward: {key}[{l}] not finite")
            tp_err = max(tp_err, float((got - want.float()).abs().max())
                         / float(want.float().abs().max()))
    if tp_err > TP_REL:
        failures.append(f"tp forward: {tp_err:.3e} of scale from the replicated forward")
    for r in ranks:
        for phase in phases:
            x = r[phase]
            log(f"spatial {phase} rank {r['rank']}: {x['s']:.3f} s, peak {x['peak']:.3f} GiB"
                + (f", exchanges {x['traffic']}" if "traffic" in x else "")
                + (f", slab bodies {x['bodies']}" if x.get("bodies") else ""))
    for name in [*segs, *FULLRES_FORWARDS, FULLRES_STEP]:
        log(f"spatial {name}: a rank's peak " + ", ".join(
            f"{r[name]['peak']:.3f}" for r in ranks) + f" GiB, the unsharded run's "
            f"{ref[name]['peak']:.3f} GiB" + (f" (phase 8b's B = 2 segmentation step "
            f"{PLAIN_SEG_PEAK_GIB} GiB)" if name in segs else "") + f"; {ranks[0][name]['s']:.3f}"
            f" s a rank, the unsharded {ref[name]['s']:.3f} s")
    log(f"spatial (phases 11a-11f): {SPACE} processes on one card (gloo), the flagship at "
        f"{cfg.input_size}; unsharded forwards " + ", ".join(
            f"{f} {ref[f]['s']:.3f} s peak {ref[f]['peak']:.3f} GiB" for f in forwards)
        + f", predict_deterministic {ref['tp_s']:.3f} s peak {ref['tp_peak']:.3f} GiB, steps "
        + ", ".join(f"{n} {ref[n]['s']:.3f} s peak {ref[n]['peak']:.3f} GiB"
                    for n in [*steps, *segs, FULLRES_STEP])
        + f"; sharded forwards {errs} of scale; split forward {tp_err:.3e} of scale; "
        f"{wall:.1f} s with start-up")
    if failures:
        raise SystemExit(f"spatial paths failed: {failures}")
    info = {"wall_s": wall, "errs": errs,
            "fwd_moved": {f: ref[f]["moved"] for f in forwards}, "tp_err": tp_err,
            "steps": step_info, "remat": remat_info, "remat_spread": remat_spread,
            "ref": {k: ref[k] for k in ("tp_s", "tp_peak")}
            | {n: {k: ref[n][k] for k in ("s", "peak")}
               for n in [*forwards, *steps, *segs, FULLRES_STEP]},
            "ranks": [{p: {k: v for k, v in r[p].items()
                           if k in ("s", "peak", "traffic", "bodies")} for p in phases}
                      for r in ranks]}
    counts = {p: add_counts(*(r[p]["counts"] for r in ranks)) for p in phases}
    return counts, info


def spatial_2d_steps(cfg_kw):
    """(name, config, rows, launches of one step) of each SPATIAL_2D_STEPS
    case: a 2D step's (`train_launches`), its Dice step's K more 2D warps
    (each level's one-hot map; their gradients are the plain versions')."""
    out = []
    for name, kw, dtype, rows in SPATIAL_2D_STEPS:
        scfg = seg_step_cfg(cfg_kw, kw, dtype, rows)
        dice = {"warp_2d": scfg.latent_levels} if "dice" in scfg.recon_loss else {}
        out.append((name, scfg, rows, add_counts(train_launches(scfg, 1), dice)))
    return out


def spatial_2d_worker(out_dir, accelerator, cfg_json) -> int:
    """One rank of phase 11g, under torchrun (SPACE ranks over gloo on the
    one card): `make_spatial_forward` of the 2D configuration at mesh (1,
    SPACE) in bf16 and f32 (SPATIAL_2D_FORWARDS), then each sharded step
    of SPATIAL_2D_STEPS (`spatial_compute_grads`), each with its launch
    counts, time, peak, exchanges and the body each 2D warp slab took;
    then one `make_spatial_train_step` update of the first step's model
    (its loss, and whether the weights moved). Rank 0 keeps the
    gradients; writes `out_dir/rank_<r>.pt`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import warp
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.parallel import multihost, spatial
    from pulpo_tpu_torch.train.step import Adam, TrainState

    dev = torch.device("cuda" if accelerator == "gpu" else "cpu")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(device=dev, backend="gloo")
    try:
        rank = torch.distributed.get_rank()
        cfg_kw = json.loads(cfg_json)
        cfg = PULPoConfig(**cfg_kw, batch_size=1)
        batch, _ = spatial_inputs(cfg, dev)
        mesh = spatial.make_2d_mesh(1, SPACE)
        block = {k: spatial.shard_volume(v, mesh) for k, v in batch.items()}
        out = {"rank": rank}
        fresh = lambda: (reset_counts(), spatial.reset_traffic())
        record = lambda seconds, peak: {
            "s": seconds, "peak": peak, "counts": read_counts(), "traffic": dict(spatial.traffic),
            "bodies": {f"{k} {b}": n for (k, b), n in sorted(warp.slab_bodies.items())}}
        for fname, dtype in zip(SPATIAL_2D_FORWARDS, STEP_DTYPES):
            model = PULPoModel(cfg.replace(compute_dtype=dtype), device=dev)
            model.init(0)
            fwd = spatial.make_spatial_forward(model, mesh)
            (df, warped), seconds, peak = peak_of(lambda: fwd(block["x"], block["y"]), fresh)
            out[fname] = {"df": df.cpu(), "warped": warped.cpu(), **record(seconds, peak)}
            del df, warped, model
        torch.backends.cudnn.deterministic = True
        for i, (name, scfg, rows, _) in enumerate(spatial_2d_steps(cfg_kw)):
            sbatch, snoise = spatial_inputs(scfg, dev, rows, segs=scfg.segs)
            sblock = {k: spatial.shard_volume(v, mesh).contiguous() for k, v in sbatch.items()}
            del sbatch
            model = PULPoModel(scfg, device=dev)
            model.init(0)
            compute = lambda: spatial.spatial_compute_grads(model, sblock, mesh, noise=snoise)
            (grads, _, metrics), seconds, peak = peak_of(compute, fresh)
            out[name] = {**record(seconds, peak),
                         "losses": {k: float(metrics[k]) for k in LOSS_KEYS},
                         "grads": {n: v.cpu() for n, v in grads.items()} if rank == 0 else None}
            del grads, metrics
            if i == 0:  # the training step's entry point: one update
                tx = Adam(scfg.lr)
                before = {n: v.clone() for n, v in model.state_dict().items()}
                state = TrainState(step=0, model=model, opt_state=tx.init(
                    dict(model.module.named_parameters())), rng=torch.Generator().manual_seed(0))
                state, step_metrics = spatial.make_spatial_train_step(model, tx, mesh)(
                    state, sblock, noise=snoise)
                out["train_step"] = {
                    "total_loss": float(step_metrics["total_loss"]),
                    "nan_flag": float(step_metrics["nan_flag"]),
                    "moved": any(not torch.equal(v, before[n])
                                 for n, v in model.state_dict().items())}
                del state, before
            del model, sblock
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        torch.save(out, pathlib.Path(out_dir) / f"rank_{rank}.pt")
    finally:
        multihost.shutdown()
    return 0


def run_spatial_2d(dev, run_root, cfg_kw=FLAGSHIP_2D):
    """Phase 11g's runs: `flagship-2d` at full width and depth (160x192,
    5 / 4 levels, n0 32, bf16) under `spatial.sharded` on SPACE torchrun
    processes sharing the card (gloo), each 2D image sharded along H.
    The forward (bf16 and f32) at mesh (1, SPACE), each rank's lines of
    the level-0 final df and warped image against the unsharded forward's
    in the same dtype, within twice the unsharded forward's own distance
    on inputs moved by one float32 ulp (at least SPATIAL_FWD_REL in bf16,
    SPATIAL_F32_REL in f32), as 11a; the step at B = 1 in bf16 and in
    f32 and the 2D OASIS Dice step (36 one-hot classes, dice_factor 50)
    in bf16 at B = 2 against the unsharded step (`held_step`), as 11b
    and 11d, with one more yardstick of the unsharded step's own
    distance under float rounding: in f32 the same step on the CPU
    (every sum in another order), in bf16 its f32 twin (the same
    network, batch and draws: its bf16 rounding error). The sharded step
    sums in other orders (the slabs' convs take other cuDNN algorithms
    than the whole image's, the BatchNorm moments and the weight
    gradients are sums of the slabs'), which a one-ulp move of the f32
    inputs does not exercise: it moves this step's gradients less than
    the 3D flagship's (in bf16 the inputs' rounding absorbs most of it).
    One
    `make_spatial_train_step` update (finite loss, no NaN flag, the
    weights moved); exact launch counts on each rank; each rank's time,
    peak and exchanged bytes beside the unsharded run's. Every check runs
    before any failure stops the phase."""
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel

    cfg = PULPoConfig(**cfg_kw, batch_size=1)
    batch, _ = spatial_inputs(cfg, dev)
    ref = {}
    for fname, dtype in zip(SPATIAL_2D_FORWARDS, STEP_DTYPES):
        model = PULPoModel(cfg.replace(compute_dtype=dtype), device=dev)
        model.init(0)
        ref[fname] = forward_reference(model, batch)
        del model
    del batch
    steps = spatial_2d_steps(cfg_kw)
    twins = {}  # a bf16 step's f32 twin (the same network, batch and draws)
    for name, scfg, rows, _ in steps:
        sbatch, snoise = spatial_inputs(scfg, dev, rows, segs=scfg.segs)
        f32 = scfg.compute_dtype == "float32"
        ref[name] = step_reference(scfg, sbatch, snoise, dev, on_host=f32)
        key = (rows, scfg.segs)
        if f32:
            twins[key] = ref[name]
        elif key not in twins:
            twins[key] = step_reference(scfg.replace(compute_dtype="float32"), sbatch, snoise, dev)
        del sbatch
    for name, scfg, rows, _ in steps:
        if scfg.compute_dtype == "bfloat16":
            twin = twins[(rows, scfg.segs)]
            ref[name]["yardsticks"]["f32"] = yardstick(ref[name], twin["grads"], twin["losses"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = run_root / "ranks"
    out.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(SPACE), os.path.abspath(__file__), "--spatial-2d-worker", str(out),
           "gpu" if dev.type == "cuda" else "cpu", json.dumps(cfg_kw)]
    proc, wall = timed(lambda: subprocess.run(cmd, capture_output=True, text=True, timeout=600))
    if proc.returncode != 0:
        raise SystemExit(f"spatial 2D: torchrun rc {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    ranks = [torch.load(out / f"rank_{r}.pt", weights_only=False) for r in range(SPACE)]
    per = cfg.input_size[0] // SPACE
    names = [name for name, *_ in steps]
    phases = [*SPATIAL_2D_FORWARDS, *names]
    failures = []
    errs = {f: {"df": 0.0, "warped": 0.0} for f in SPATIAL_2D_FORWARDS}
    expected = {f: decode_launches(cfg, 1, 1) for f in SPATIAL_2D_FORWARDS}
    expected.update({name: want for name, _, _, want in steps})
    for r in ranks:
        sl = slice(r["rank"] * per, (r["rank"] + 1) * per)
        for fname in SPATIAL_2D_FORWARDS:
            for k in ("df", "warped"):
                want, got = ref[fname][k][:, sl].float(), r[fname][k].float()
                if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                    failures.append(f"{fname} rank {r['rank']}: {k} {tuple(got.shape)}")
                    continue
                diff = (got - want).abs()
                errs[fname][k] = max(errs[fname][k],
                                     float(diff.max()) / float(ref[fname][k].abs().max()))
                line = int(diff.amax(dim=(0, 2, 3)).argmax()) + sl.start
                rel = float(diff.square().sum().sqrt() / want.square().sum().sqrt())
                log(f"spatial {fname} rank {r['rank']}: {k} {float(diff.max()):.3e} at most "
                    f"(line {line}), {rel:.3e} relative L2")
        for phase, want in expected.items():
            try:
                expect(r[phase]["counts"], want, f"spatial {phase} rank {r['rank']}")
            except SystemExit as e:
                failures.append(str(e))
        t = r["train_step"]
        if not (math.isfinite(t["total_loss"]) and t["nan_flag"] == 0.0 and t["moved"]):
            failures.append(f"2D make_spatial_train_step rank {r['rank']}: {t}")
    for fname, dtype in zip(SPATIAL_2D_FORWARDS, STEP_DTYPES):
        moved = ref[fname]["moved"]
        floor = SPATIAL_FWD_REL if dtype == "bfloat16" else SPATIAL_F32_REL
        log(f"spatial {fname}: {errs[fname]} of scale from the unsharded forward; the unsharded "
            f"forward on inputs moved by one float32 ulp {moved}")
        if any(errs[fname][k] > max(2 * moved[k], floor) for k in errs[fname]):
            failures.append(f"{fname}: {errs[fname]} of scale from the unsharded forward (its "
                            f"own distance under a one-ulp move of the inputs {moved})")
    step_info = {}
    for name, _, dtype, _ in SPATIAL_2D_STEPS:
        if any(r[name]["losses"] != ranks[0][name]["losses"] for r in ranks):
            failures.append(f"{name}: the ranks' losses differ")
        step_info[name] = held_step(name, ranks[0][name], ref[name], dtype, failures)
    for r in ranks:
        for phase in phases:
            x = r[phase]
            nbytes = sum(v[1] for v in x["traffic"].values())
            log(f"spatial {phase} rank {r['rank']}: {x['s']:.4f} s, peak {x['peak']:.3f} GiB "
                f"(unsharded {ref[phase]['s']:.4f} s, {ref[phase]['peak']:.3f} GiB), exchanged "
                f"{nbytes / 1e6:.2f} MB {x['traffic']}, slab bodies {x['bodies']}")
        log(f"spatial 2D make_spatial_train_step rank {r['rank']}: {r['train_step']}")
    log(f"spatial 2D (phase 11g): {SPACE} processes on one card (gloo), flagship-2d at "
        f"{cfg.input_size}; sharded forwards {errs} of scale; {wall:.1f} s with start-up")
    if failures:
        raise SystemExit(f"spatial 2D failed: {failures}")
    info = {"wall_s": wall, "errs": errs,
            "fwd_moved": {f: ref[f]["moved"] for f in SPATIAL_2D_FORWARDS}, "steps": step_info,
            "ref": {p: {k: ref[p][k] for k in ("s", "peak")} for p in phases},
            "ranks": [{p: {k: v for k, v in r[p].items()
                           if k in ("s", "peak", "traffic", "bodies")} for p in phases}
                      for r in ranks]}
    counts = {p: add_counts(*(r[p]["counts"] for r in ranks)) for p in phases}
    return counts, info


def time_ms(fn, iters, warmup=2):
    """ms per call: the median of TIME_REPEATS CUDA-event timings of
    `iters` calls each (one timing alone moves by up to 2x between runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(TIME_REPEATS):
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    return statistics.median(runs)


def graph_ms(fn, iters=20):
    """ms per call of `fn` on the device alone: `iters` calls captured in
    one CUDA graph, replayed (the median of TIME_REPEATS CUDA-event
    timings). For calls whose kernels take less device time than the
    host needs to issue them, where `time_ms` measures the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(TIME_REPEATS):
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    return statistics.median(runs)


def grid_for(df):
    """grid_sample's normalized (x, y, z) grid for a df ((x, y) in 2D):
    the reference SpatialTransformer's 2 * (loc / (size - 1) - 0.5)."""
    import torch

    size = df.shape[1:-1]
    axes = [torch.arange(s, device=df.device, dtype=torch.float32) for s in size]
    mesh = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    loc = mesh[None] + df
    norm = torch.stack([2 * (loc[..., i] / (size[i] - 1) - 0.5) for i in range(len(size))], -1)
    return norm.flip(-1).contiguous()


def squaring_library(v, cf=False):
    """One squaring step as one PyTorch expression, the library yardstick
    of the squaring kernels: v + grid_sample(v, identity + v) with border
    padding and align_corners=False, the grid built in the call (the
    kernel derives its coordinates from v every step). `cf`: v is
    channels-first (R, nd, *S), grid_sample's own layout; else
    channels-last (R, *S, nd), and the result is permuted back."""
    import torch.nn.functional as F

    vcf = v if cf else v.movedim(-1, 1)
    warped = F.grid_sample(vcf, grid_for(vcf.movedim(1, -1)), mode="bilinear",
                           padding_mode="border", align_corners=False)
    return v + (warped if cf else warped.movedim(1, -1))


def time_squaring_library(v, cf=False, graph=False):
    """ms of `squaring_library(v)` and of its grid_sample alone (the grid
    built beforehand): CUDA-event medians, or device times of a CUDA
    graph (`graph`) for calls shorter than their host side. Logs the
    largest difference from the kernel's step."""
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import squaring

    timer = graph_ms if graph else (lambda fn: time_ms(fn, 10))
    vcf = v if cf else v.movedim(-1, 1)
    grid = grid_for(vcf.movedim(1, -1))
    ms = timer(lambda: squaring_library(v, cf))
    gs = timer(lambda: F.grid_sample(vcf, grid, mode="bilinear", padding_mode="border",
                                     align_corners=False))
    kernel = squaring.squaring_step_cf(v) if cf else squaring.squaring_step(v)
    log(f"squaring library ({'CF' if cf else 'CL'} {tuple(v.shape)}): one expression "
        f"{ms:.5f} ms, grid_sample alone {gs:.5f} ms; max abs diff from the kernel "
        f"{float((squaring_library(v, cf) - kernel).abs().max()):.3e}")
    return ms, gs


def time_kernels(dev, full, level0, rows, zdim, n0):
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import squaring, vel_head, warp

    res = {}
    # warp at level 0: one moving image, `rows` sample dfs at full res
    img = torch.rand((1, *full, 1), device=dev)
    df = smooth_field(rows, full, 3.0, seed=11, device=dev)
    n = math.prod(full)
    bytes_ = 4 * (rows * n * 3 + rows * n * 1 + n)
    ms = time_ms(lambda: warp.warp(img, df), 10)
    plain = time_ms(lambda: warp.warp_plain(img, df), 2, warmup=1)
    grid = grid_for(df)
    mov = img.permute(0, 4, 1, 2, 3).expand(rows, -1, -1, -1, -1)
    lib = time_ms(lambda: F.grid_sample(mov, grid, mode="bilinear", padding_mode="border",
                                        align_corners=False), 10)
    gs = F.grid_sample(mov, grid, mode="bilinear", padding_mode="border", align_corners=False)
    log(f"grid_sample vs warp kernel max abs diff {float((gs.permute(0, 2, 3, 4, 1) - warp.warp(img, df)).abs().max()):.3e}")
    res["warp"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                       shape=f"moving (1,{','.join(map(str, full))},1) df ({rows},{','.join(map(str, full))},3) f32")
    del df, grid, mov, gs
    torch.cuda.empty_cache()

    # squaring: one step at level 0 on `rows` fields
    v = smooth_field(rows, level0, 3.0, seed=12, device=dev)
    out = torch.empty_like(v)
    nl = math.prod(level0)
    ms = time_ms(lambda: squaring.squaring_step(v, out), 20)
    plain = time_ms(lambda: squaring.squaring_step_plain(v), 3, warmup=1)
    lib, gs = time_squaring_library(v)
    res["squaring"] = dict(ms=ms, plain_ms=plain, library_ms=lib, library_grid_sample_ms=gs,
                           bound_ms=2 * rows * nl * 3 * 4 / HBM_BYTES_PER_S * 1e3,
                           bound_by="bytes",
                           shape=f"({rows},{','.join(map(str, level0))},3) f32, one step")
    del v, out
    torch.cuda.empty_cache()

    # velocity head at level 0 in bf16
    p = head_params(zdim, n0, seed=13, device=dev)
    z = torch.randn((rows, *level0, zdim), device=dev, dtype=torch.bfloat16)
    flops = rows * nl * (2 * 27 * zdim * n0 + 2 * 27 * n0 * n0 + 2 * n0 * 3)
    bytes_ = rows * nl * (zdim + 3) * 2
    ms = time_ms(lambda: vel_head.velocity_head(z, p), 5)
    plain = time_ms(lambda: vel_head.velocity_head_plain(z, p), 2, warmup=1)
    bf = {k: t.to(torch.bfloat16) for k, t in p.items() if k.startswith(("k", "b"))}
    aff = [vel_head.head_bn(p, i) for i in (1, 2)]

    def cudnn_chain():
        x = z.permute(0, 4, 1, 2, 3)
        for i in (1, 2):
            x = F.conv3d(x, bf[f"k{i}"], bf[f"b{i}"], padding=1)
            m, mul, add = (t.view(1, -1, 1, 1, 1) for t in aff[i - 1])
            x = F.leaky_relu(((x.float() - m) * mul + add).to(torch.bfloat16), 0.2)
        return F.conv3d(x, bf["k3"], bf["b3"])

    lib = time_ms(cudnn_chain, 5)
    res["vel_head"] = dict(ms=ms, plain_ms=plain, library_ms=lib, tflop_per_s=flops / ms * 1e-9,
                           bound_ms=max(flops / BF16_FLOP_PER_S, bytes_ / HBM_BYTES_PER_S) * 1e3,
                           bound_by="operations" if flops / BF16_FLOP_PER_S > bytes_ / HBM_BYTES_PER_S else "bytes",
                           shape=f"z ({rows},{','.join(map(str, level0))},{zdim}) bf16, n0 {n0}")
    return res


def time_lungct_warp(dev, full):
    """The warp at the LungCT shape: one moving image and one df under
    the respiratory field, and the same under a smooth 3-voxel field for
    the time per voxel at small displacements."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import warp

    img = torch.rand((1, *full, 1), device=dev)
    df = respiratory_field(full, SI_RAMP, DRIFT, dev)
    n = math.prod(full)
    ms = time_ms(lambda: warp.warp(img, df), 20)
    plain = time_ms(lambda: warp.warp_plain(img, df), 2, warmup=1)
    grid = grid_for(df)
    mov = img.permute(0, 4, 1, 2, 3)
    lib = time_ms(lambda: F.grid_sample(mov, grid, mode="bilinear", padding_mode="border",
                                        align_corners=False), 20)
    small = smooth_field(1, full, 3.0, seed=14, device=dev)
    small_ms = time_ms(lambda: warp.warp(img, small), 20)
    del df, grid, small
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, small_displacement_ms=small_ms,
                bound_ms=4 * n * (3 + 1 + 1) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                shape=f"moving (1,{','.join(map(str, full))},1) df (1,{','.join(map(str, full))},3) "
                      f"f32, ramp {SI_RAMP:g} drift {DRIFT:g}")


def time_backward_kernels(dev, cfg):
    """The training path's moving-cotangent, squaring backward and box sum
    at its shapes (B = 1; the df-cotangent: `time_training_shapes`). Bounds count
    each input read once and each output written once; every one of
    these kernels does far fewer float32 operations per byte than the
    card's 67 TFLOP/s against 3.35 TB/s, so bytes bound them. The squaring
    backward and the box sum take less device time than their wrappers'
    host side: `ms` is their device time (`graph_ms`), `eager_ms` the
    per-call time of a loop of eager calls."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import box_sum, squaring, warp

    res = {}
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    n, nl = math.prod(full), math.prod(level0)
    fmt = lambda size: ",".join(map(str, size))

    # moving-cotangent at level 0, C = 3 (its role in the squaring backward)
    df = smooth_field(1, level0, 3.0, seed=32, device=dev)
    cot = torch.randn((1, *level0, 3), device=dev)
    shape = (1, *level0, 3)
    ms = time_ms(lambda: warp.warp_mgrad(shape, df, cot), 20)
    plain = time_ms(lambda: warp.warp_mgrad_plain(shape, df, cot), 2, warmup=1)
    mov = torch.rand((1, 3, *level0), device=dev, requires_grad=True)
    out = F.grid_sample(mov, grid_for(df), mode="bilinear", padding_mode="border",
                        align_corners=False)
    gcf = cot.permute(0, 4, 1, 2, 3)
    lib = time_ms(lambda: torch.autograd.grad(out, mov, gcf, retain_graph=True), 20)
    res["warp_mgrad"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=nl * (12 + 12 + 12) / HBM_BYTES_PER_S * 1e3,
                             bound_by="bytes", shape=f"df/g/out (1,{fmt(level0)},3) f32")
    del df, cot, mov, out, gcf

    # squaring backward: one step at level 0; the library yardstick is
    # the grid_sample VJP of one step v + grid_sample(v, identity + v)
    v = smooth_field(1, level0, 3.0, seed=33, device=dev)
    cot = torch.randn((1, *level0, 3), device=dev)
    eager = time_ms(lambda: squaring.squaring_step_bwd(v, cot), 20)
    ms = graph_ms(lambda: squaring.squaring_step_bwd(v, cot))
    plain = time_ms(lambda: squaring.squaring_step_bwd_plain(v, cot), 2, warmup=1)
    vg = v.clone().requires_grad_(True)
    step = vg + F.grid_sample(vg.permute(0, 4, 1, 2, 3), grid_for(vg), mode="bilinear",
                              padding_mode="border", align_corners=False).permute(0, 2, 3, 4, 1)
    lib = time_ms(lambda: torch.autograd.grad(step, vg, cot, retain_graph=True), 20)
    res["squaring_bwd"] = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                               bound_ms=nl * (12 + 12 + 12) / HBM_BYTES_PER_S * 1e3,
                               bound_by="bytes", shape=f"v/g (1,{fmt(level0)},3) f32, one step")
    del v, vg, step, cot

    # box sum at level 0's recon size (full res), window 9
    x = torch.rand((1, *full), device=dev)
    eager = time_ms(lambda: box_sum.box_sum(x, 9), 20)
    ms = graph_ms(lambda: box_sum.box_sum(x, 9))
    plain = time_ms(lambda: box_sum.box_sum_plain(x, 9), 2, warmup=1)
    x5 = x[:, None]
    lib = time_ms(lambda: F.avg_pool3d(x5, 9, stride=1, padding=4,
                                       count_include_pad=True) * 729.0, 10)
    res["box_sum"] = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                          bound_ms=n * (4 + 4) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                          shape=f"(1,{fmt(full)}) f32, window 9")
    del x, x5
    torch.cuda.empty_cache()
    return res


def library_unit(x, u, y2=None):
    """One eval ConvUnit as models/blocks.py ran it before the conv-unit
    kernel: a cuDNN conv, then the PyTorch epilogue passes (the library
    yardstick; the port never calls this)."""
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels.vel_head import bn_affine, eval_bn, leaky
    from pulpo_tpu_torch.models.blocks import tile_rows

    # cuDNN at every width (models/blocks.conv_cl now takes a narrow
    # input to the narrow-conv kernel)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), u["k"].to(x.dtype), padding=1).permute(0, 2, 3, 4, 1)
    if y2 is not None:
        y = y + tile_rows(y2, y.shape[0])
    y = y + u["b"].to(x.dtype)
    return leaky(eval_bn(y, *bn_affine(u["mean"], u["var"], u["scale"], u["bias"])))


def library_head(fb, y2, p):
    from pulpo_tpu_torch.kernels import pos_head
    from pulpo_tpu_torch.models.blocks import conv1x1_cl, softplus

    u1, u2, m1, m2 = pos_head.units(p)
    x = library_unit(library_unit(fb, u1), u2)
    x = library_unit(library_unit(x, m1, y2), m2)
    dt = x.dtype
    return (conv1x1_cl(x, p["hkmu"]) + p["hbmu"].to(dt),
            softplus(conv1x1_cl(x, p["hksig"]) + p["hbsig"].to(dt)))


def chain_flop_per_voxel(widths):
    return sum(2 * 27 * a * b for a, b in zip(widths[:-1], widths[1:]))


def time_eval_kernels(dev, cfg, rows, checks):
    """The posterior head at each non-coarsest flagship level at R = rows
    (one pair), and the conv chain on down_block_0 at full resolution, in
    bf16. Bounds: the conv FLOPs (and the heads') over 989 TFLOP/s, or
    each input and output once over 3.35 TB/s where that is larger. The
    head is also held against its plain version on these inputs
    (BF16_CHAIN_REL of scale, as phase 3d on 4 rows): the persistent grid
    at the size it is timed at."""
    import torch

    from pulpo_tpu_torch.kernels import conv_chain, pos_head

    res, levels = {}, {}
    bf = torch.bfloat16
    gd = torch.Generator(device=dev).manual_seed(90)
    for l in range(cfg.latent_levels - 1):
        c_fb, n_up, n_merge = widths = pos_head_widths(cfg, l)
        size = cfg.level_sizes[l]
        p = pos_head_params(widths, cfg.zdim, 91 + l, dev)
        fb = torch.randn((rows, *size, c_fb), generator=gd, device=dev).to(bf)
        y2 = torch.randn((1, *size, n_merge), generator=gd, device=dev).to(bf)
        nv = rows * math.prod(size)
        flops = nv * (chain_flop_per_voxel((c_fb, n_up, n_up, n_merge, n_merge))
                      + 2 * 2 * cfg.zdim * n_merge)
        bytes_ = 2 * (nv * c_fb + math.prod(size) * n_merge + nv * 2 * cfg.zdim)
        ms = time_ms(lambda: pos_head.posterior_head(fb, y2, p), 1, warmup=1)
        torch.cuda.empty_cache()
        lib = time_ms(lambda: library_head(fb, y2, p), 1, warmup=1)
        torch.cuda.empty_cache()
        plain = time_ms(lambda: pos_head.posterior_head_plain(fb, y2, p), 1, warmup=1)
        torch.cuda.empty_cache()
        got = pos_head.posterior_head(fb, y2, p)
        ref = pos_head.posterior_head_plain(fb, y2, p)
        for what, a, b in zip(("mu", "sigma"), got, ref):
            checks.record("pos_head", f"bf16 {what} {rows} rows {'x'.join(map(str, size))} "
                          f"{'/'.join(map(str, widths))}", a, b, scaled(b, BF16_CHAIN_REL))
        del got, ref
        torch.cuda.empty_cache()
        t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
        levels[l] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         tflop_per_s=flops / ms * 1e-9,
                         shape=f"fb ({rows},{','.join(map(str, size))},{c_fb}) y2 (1,...,"
                               f"{n_merge}) bf16, {c_fb}/{n_up}/{n_merge}, {rows} rows")
        del fb, y2
        torch.cuda.empty_cache()
    res["pos_head"] = dict(levels[0], levels=levels)

    size = cfg.input_size
    widths = (2, cfg.n0, cfg.n0, cfg.n0)
    stages = chain_stages(widths, 95, dev)
    x = torch.rand((1, *size, 2), generator=gd, device=dev).to(bf)
    nv = math.prod(size)
    flops = nv * chain_flop_per_voxel(widths)
    bytes_ = 2 * nv * (widths[0] + widths[-1])
    ms = time_ms(lambda: conv_chain.conv_chain(x, stages), 3)
    lib = time_ms(lambda: library_unit(library_unit(library_unit(x, stages[0]), stages[1]),
                                       stages[2]), 3)
    plain = time_ms(lambda: conv_chain.conv_chain_plain(x, stages), 1, warmup=1)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    res["conv_chain"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(t_ops, t_bytes),
                             bound_by="operations" if t_ops >= t_bytes else "bytes",
                             tflop_per_s=flops / ms * 1e-9,
                             shape=f"x (1,{','.join(map(str, size))},2) bf16, "
                                   f"{'/'.join(map(str, widths))}")
    del x
    torch.cuda.empty_cache()
    return res


def time_fullres_kernels(dev, cfg, chunk):
    """The channels-first kernels at the full-res request's shapes, each
    beside its channels-last twin. `cfg`: the flagship-fullres config;
    `chunk`: its request's. Bounds: each input read once and each output
    written once over 3.35 TB/s (the gathers do ~100 float32 operations
    per voxel: bytes bound them)."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import squaring, warp

    res = {}
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    fmt = lambda size: ",".join(map(str, size))
    cf = lambda v: v.permute(0, 4, 1, 2, 3)
    n, nl = math.prod(full), math.prod(level0)

    # squaring: one step at level 0 on `chunk` fields, CF and its CL twin
    v = cf(smooth_field(chunk, level0, 3.0, seed=120, device=dev)).contiguous()
    out = torch.empty_like(v)
    v_cl = v.permute(0, 2, 3, 4, 1).contiguous()
    out_cl = torch.empty_like(v_cl)
    ms = time_ms(lambda: squaring.squaring_step_cf(v, out), 20)
    twin = time_ms(lambda: squaring.squaring_step(v_cl, out_cl), 20)
    plain = time_ms(lambda: squaring.squaring_step_cf_plain(v), 3, warmup=1)
    lib, gs = time_squaring_library(v, cf=True)
    res["squaring_cf"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              library_grid_sample_ms=gs, cl_twin_ms=twin,
                              bound_ms=2 * chunk * nl * 3 * 4 / HBM_BYTES_PER_S * 1e3,
                              bound_by="bytes",
                              shape=f"({chunk},3,{fmt(level0)}) f32, one step")
    del v, out, v_cl, out_cl
    torch.cuda.empty_cache()

    # the decode's batched image warp: 4 levels x `chunk` rows at full res
    rows = cfg.latent_levels * chunk
    img = torch.rand((1, *full, 1), device=dev)
    df_cl = smooth_field(rows, full, 3.0, seed=121, device=dev)
    df = cf(df_cl).contiguous()
    ms = time_ms(lambda: warp.warp_cf(cf(img), df), 5)
    twin = time_ms(lambda: warp.warp(img, df_cl), 5)
    del df_cl
    torch.cuda.empty_cache()
    # the plain version in `chunk`-row slices (its index temporaries for
    # all rows at once would not fit): the sum of the slices' times
    plain = sum(time_ms(lambda i=i: warp.warp_cf_plain(cf(img), df[i:i + chunk]), 1, warmup=1)
                for i in range(0, rows, chunk))
    grid = grid_for(df.permute(0, 2, 3, 4, 1))
    mov = cf(img).expand(rows, -1, -1, -1, -1)
    lib = time_ms(lambda: F.grid_sample(mov, grid, mode="bilinear", padding_mode="border",
                                        align_corners=False), 5)
    res["warp_cf"] = dict(ms=ms, plain_ms=plain, library_ms=lib, cl_twin_ms=twin,
                          bound_ms=4 * (rows * n * 3 + rows * n + n) / HBM_BYTES_PER_S * 1e3,
                          bound_by="bytes",
                          shape=f"moving (1,1,{fmt(full)}) df ({rows},3,{fmt(full)}) f32")
    del grid, mov
    # the request's mean tail: the image by the 4 levels' mean dfs
    tail = df[::chunk].contiguous()
    grid = grid_for(tail.permute(0, 2, 3, 4, 1))
    mov = cf(img).expand(tail.shape[0], -1, -1, -1, -1)
    res["warp_cf"]["mean_tail"] = dict(
        ms=time_ms(lambda: warp.warp_cf(cf(img), tail), 20),
        plain_ms=time_ms(lambda: warp.warp_cf_plain(cf(img), tail), 2, warmup=1),
        library_ms=time_ms(lambda: F.grid_sample(mov, grid, mode="bilinear", padding_mode="border",
                                                 align_corners=False), 20),
        bound_ms=4 * (tail.shape[0] * n * 4 + n) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=f"moving (1,1,{fmt(full)}) df ({tail.shape[0]},3,{fmt(full)}) f32")
    del img, df, grid, mov, tail
    torch.cuda.empty_cache()

    return res


def time_training_shapes(dev):
    """The narrow conv (#12) and the warp's df-cotangent (#6) at every
    shape a B = 1 training step of the flagship and LungCT configurations
    launches: the conv in bf16, 2 -> n0 at the input size and zdim -> n0
    at each latent level; the df-cotangent, C = 1, of each level's image
    by its df (level 0 at the input size), under a smooth 3-voxel field
    (flagship) or the respiratory ramp (LungCT). `ms` is device time
    (`graph_ms`; the conv's weights packed beforehand), `eager_ms` a loop
    of wrapper calls (the conv's packs its weights each call). Library
    yardsticks: cuDNN `conv3d` on the channels-first view, and
    grid_sample's VJP with respect to the grid (eager). Bounds: each
    input read once and each output written once over 3.35 TB/s, or the
    conv's operations at bf16 peak where that is larger. Returns
    {kernel: record of the flagship's first shape with `shapes`}."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import conv_narrow, warp

    fmt = lambda size: "x".join(map(str, size))
    conv, dfgrad = {}, {}
    for tag, cfg_kw in (("flagship", FLAGSHIP), ("LungCT", LUNGCT)):
        cfg = PULPoConfig(**cfg_kw)
        for i, (cin, size) in enumerate(narrow_shapes(cfg_kw)):
            w = narrow_weight(cin, cfg.n0, 122 + i, dev)
            x = torch.randn((1, *size, cin), device=dev).to(torch.bfloat16)
            nv = math.prod(size)
            flops, bytes_ = 2 * 27 * cin * cfg.n0 * nv, 2 * nv * (cin + cfg.n0)
            with torch.no_grad():
                packed = conv_narrow.pack_weights(w)
                ms = graph_ms(lambda: conv_narrow.conv_packed(x, packed, cfg.n0))
                eager = time_ms(lambda: conv_narrow.conv_narrow(x, w), 10)
                plain = time_ms(lambda: conv_narrow.conv_narrow_plain(x, w), 1, warmup=1)
                xc, wb = x.permute(0, 4, 1, 2, 3), w.to(torch.bfloat16)
                lib = graph_ms(lambda: F.conv3d(xc, wb, padding=1))
            t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
            conv[f"{tag} {cin}->{cfg.n0} {fmt(size)}"] = dict(
                ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                shape=f"x (1,{fmt(size)},{cin}) bf16 -> {cfg.n0}")
            del w, x, packed, xc, wb
        for l in range(cfg.latent_levels):
            size = cfg.input_size if l == 0 else cfg.level_sizes[l]
            img = torch.rand((1, *size, 1), device=dev)
            df = (smooth_field(1, size, 3.0, seed=130 + l, device=dev) if tag == "flagship"
                  else respiratory_field(size, SI_RAMP / 2**l, DRIFT / 2**l, dev))
            cot = torch.randn((1, *size, 1), device=dev)
            ms = graph_ms(lambda: warp.warp_dfgrad(img, df, cot))
            eager = time_ms(lambda: warp.warp_dfgrad(img, df, cot), 10)
            plain = time_ms(lambda: warp.warp_dfgrad_plain(img, df, cot), 2, warmup=1)
            grid = grid_for(df).requires_grad_(True)
            out = F.grid_sample(img.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                                padding_mode="border", align_corners=False)
            gcf = cot.permute(0, 4, 1, 2, 3)
            lib = time_ms(lambda: torch.autograd.grad(out, grid, gcf, retain_graph=True), 10)
            dfgrad[f"{tag} level {l} {fmt(size)}"] = dict(
                ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                bound_ms=math.prod(size) * (4 + 12 + 4 + 12) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", shape=f"moving (1,{fmt(size)},1) df/g (1,{fmt(size)},3/1) f32")
            if l == 0:
                # the step's level-0 df is the resize's output, (S0, S1, 3, S2)
                # in memory: the wrapper's `df.contiguous()` copies it
                strided = df.movedim(-1, -2).contiguous().movedim(-2, -1)
                dfgrad[f"{tag} level {l} {fmt(size)}"]["df_copy_ms"] = graph_ms(
                    lambda: strided.contiguous())
                del strided
            del img, df, cot, grid, out, gcf
        torch.cuda.empty_cache()
    res = {}
    for name, shapes in (("conv_narrow", conv), ("warp_dfgrad", dfgrad)):
        first = next(iter(shapes.values()))
        res[name] = dict(first, shapes={k: {a: b for a, b in r.items() if a != "shape"}
                                        for k, r in shapes.items()})
    return res


def time_2d_kernels(dev, cfg, rows):
    """The 2D kernels at the `flagship-2d` paths' shapes: the squaring
    step on `rows` fields at level 0 (the request's chunk), the warp of
    the full-size image by `rows` full-size dfs (the level-0 warp of a
    decode chunk), the box sum at level 0's NCC size with window 9. Each
    reads its input once and writes its output once; bytes bound them.
    At these sizes a call's kernels take less device time than its host
    side takes to issue them, so `ms` and `library_ms` are device times
    (`graph_ms`) and `eager_ms` / `library_eager_ms` the per-call times
    of a loop of eager calls (`time_ms`)."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import box_sum, squaring, warp

    res = {}
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    fmt = lambda size: ",".join(map(str, size))
    n, nl = math.prod(full), math.prod(level0)

    v = smooth_field(rows, level0, 3.0, seed=240, device=dev, channels=2)
    out = torch.empty_like(v)
    eager = time_ms(lambda: squaring.squaring_step(v, out), 50)
    ms = graph_ms(lambda: squaring.squaring_step(v, out))
    plain = time_ms(lambda: squaring.squaring_step_plain(v), 5, warmup=1)
    lib, gs = time_squaring_library(v, graph=True)
    lib_eager = time_ms(lambda: squaring_library(v), 50)
    res["squaring_2d"] = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                              library_eager_ms=lib_eager, library_grid_sample_ms=gs,
                              bound_ms=2 * rows * nl * 2 * 4 / HBM_BYTES_PER_S * 1e3,
                              bound_by="bytes", shape=f"({rows},{fmt(level0)},2) f32, one step")

    img = torch.rand((1, *full, 1), device=dev)
    df = smooth_field(rows, full, 3.0, seed=241, device=dev, channels=2)
    eager = time_ms(lambda: warp.warp(img, df), 20)
    ms = graph_ms(lambda: warp.warp(img, df))
    plain = time_ms(lambda: warp.warp_plain(img, df), 3, warmup=1)
    grid = grid_for(df)
    mov = img.movedim(-1, 1).expand(rows, -1, -1, -1)
    library = lambda: F.grid_sample(mov, grid, mode="bilinear", padding_mode="border",
                                    align_corners=False)
    lib_eager = time_ms(library, 20)
    lib = graph_ms(library)
    gs = F.grid_sample(mov, grid, mode="bilinear", padding_mode="border", align_corners=False)
    log(f"grid_sample 2D vs warp_2d kernel max abs diff "
        f"{float((gs.movedim(1, -1) - warp.warp(img, df)).abs().max()):.3e}")
    res["warp_2d"] = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                          library_eager_ms=lib_eager,
                          bound_ms=4 * (rows * n * 2 + rows * n + n) / HBM_BYTES_PER_S * 1e3,
                          bound_by="bytes",
                          shape=f"moving (1,{fmt(full)},1) df ({rows},{fmt(full)},2) f32")

    x = torch.rand((1, *full), device=dev)
    win = cfg.window_size[0]
    eager = time_ms(lambda: box_sum.box_sum(x, win), 50)
    ms = graph_ms(lambda: box_sum.box_sum(x, win))
    plain = time_ms(lambda: box_sum.box_sum_plain(x, win), 5, warmup=1)
    x4 = x[:, None]
    library = lambda: F.avg_pool2d(x4, win, stride=1, padding=win // 2,
                                   count_include_pad=True) * float(win * win)
    lib_eager = time_ms(library, 50)
    lib = graph_ms(library)
    res["box_sum_2d"] = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                             library_eager_ms=lib_eager,
                             bound_ms=n * (4 + 4) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                             shape=f"(1,{fmt(full)}) f32, window {win}")
    del v, out, img, df, grid, mov, gs, x, x4
    torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} in {time.perf_counter() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    cfg = PULPoConfig(**FLAGSHIP)
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    t = time.perf_counter()
    checks = Checks()
    check_kernels(dev, full, level0, checks)
    torch.cuda.empty_cache()
    check_backward_kernels(dev, cfg, checks)
    torch.cuda.empty_cache()
    check_large_displacement(dev, PULPoConfig(**LUNGCT), checks)
    torch.cuda.empty_cache()
    check_eval_kernels(dev, checks)
    torch.cuda.empty_cache()
    check_cf_kernels(dev, checks)
    torch.cuda.empty_cache()
    check_conv_narrow(dev, checks)
    torch.cuda.empty_cache()
    cfg_2d = PULPoConfig(**FLAGSHIP_2D)
    check_2d_kernels(dev, cfg_2d, checks)
    torch.cuda.empty_cache()
    check_seg_kernels(dev, PULPoConfig(**OASIS), cfg_2d, checks)
    if checks.failures:
        raise SystemExit(f"kernel checks failed: {checks.failures}")
    log(f"kernel checks passed in {time.perf_counter() - t:.1f} s")
    check_small_reference(dev)
    check_small_reference(dev, **FULLRES_KW)
    check_small_train(dev)
    check_small_reference(dev, size=(32, 40))
    check_small_train(dev, size=(32, 40))
    check_vxm_small(dev)

    uq_counts, uq = run_main_path(dev, FLAGSHIP, N_SAMPLES, N_REQUESTS)
    chunk = uq["chunk"]
    torch.cuda.empty_cache()
    serve_root = tempfile.mkdtemp(prefix="pulpo_serve_")
    try:
        serve_counts, serve = run_serve_path(dev, FLAGSHIP, N_SAMPLES, chunk, N_REQUESTS,
                                             serve_root)
    finally:
        shutil.rmtree(serve_root, ignore_errors=True)
    torch.cuda.empty_cache()
    fullres_counts, fullres = run_main_path(dev, FLAGSHIP_FULLRES, N_SAMPLES, N_REQUESTS,
                                            name="fullres serving path")
    torch.cuda.empty_cache()
    train_counts, train = run_train_path(dev, FLAGSHIP, TRAIN_STEPS)
    torch.cuda.empty_cache()
    uq2d_counts, uq2d = run_main_path(dev, FLAGSHIP_2D, N_SAMPLES, N_REQUESTS,
                                      name="2D serving path")
    torch.cuda.empty_cache()
    train2d_counts, train2d = run_train_path(dev, FLAGSHIP_2D, TRAIN_STEPS)
    torch.cuda.empty_cache()
    run_root = pathlib.Path(tempfile.mkdtemp(prefix="pulpo_lungct_"))
    try:
        lungct_train, lungct_eval, lungct = run_lungct_path(
            dev, LUNGCT, LUNGCT_STEPS, LUNGCT_SAMPLES, run_root)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    torch.cuda.empty_cache()
    cli_root = tempfile.mkdtemp(prefix="pulpo_cli2d_")
    try:
        cli2d_counts = run_train_cli_2d(dev, CLI_2D_STEPS, cli_root)
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
    torch.cuda.empty_cache()
    oasis_root = pathlib.Path(tempfile.mkdtemp(prefix="pulpo_oasis_"))
    try:
        oasis2d_counts, oasis2d_dir, oasis2d_stores = run_oasis_2d(
            dev, OASIS_2D_STEPS, OASIS_SAMPLES, oasis_root / "2d")
        torch.cuda.empty_cache()
        serve2d_counts, serve2d = run_serve_path(dev, FLAGSHIP_2D, N_SAMPLES, uq2d["chunk"],
                                                 N_REQUESTS, oasis_root)
        torch.cuda.empty_cache()
        oasis_train, oasis_eval, oasis, stores = run_oasis_path(
            dev, OASIS, OASIS_STEPS, OASIS_SAMPLES, oasis_root / "3d")
        torch.cuda.empty_cache()
        remat_counts, remat = run_remat_path(dev, OASIS, stores)
        torch.cuda.empty_cache()
        panel_rounds = run_panels_check(oasis["run_dir"])
        fig_counts, fig = run_figure_path(dev, oasis["run_dir"], stores, OASIS_SAMPLES, "oasis")
        torch.cuda.empty_cache()
        fig2d_counts, fig2d = run_figure_path(dev, oasis2d_dir, oasis2d_stores, OASIS_SAMPLES,
                                              "oasis 2D")
        del oasis2d_stores
        torch.cuda.empty_cache()
        vxm_counts, vxm = run_vxm_path(dev, FLAGSHIP["input_size"], stores, VXM_SAMPLES,
                                       VXM_STEPS, oasis_root)
        torch.cuda.empty_cache()
        cmp_counts, cmp = run_compare_path(dev, oasis["run_dir"], stores, COMPARE_SAMPLES,
                                           oasis_root)
        torch.cuda.empty_cache()
        native_counts, native = run_native_path(dev, OASIS, OASIS_STEPS, stores, oasis,
                                                oasis_root / "native")
        del stores
        torch.cuda.empty_cache()
        brats_counts, brats = run_brats_path(dev, BRATS_STEPS, oasis_root / "brats")
    finally:
        shutil.rmtree(oasis_root, ignore_errors=True)
    torch.cuda.empty_cache()
    reset_counts()
    ingest = run_ingest_path(dev)
    ingest_counts = read_counts()
    torch.cuda.empty_cache()
    dp_counts, dp = run_dp_world1(dev, FLAGSHIP, DP_TIMED_STEPS, train["step_s"])
    torch.cuda.empty_cache()
    dp_root = pathlib.Path(tempfile.mkdtemp(prefix="pulpo_dp_"))
    try:
        cli_dp_counts, cli_dp = run_train_cli_dp(dev, dp_root)
    finally:
        shutil.rmtree(dp_root, ignore_errors=True)
    torch.cuda.empty_cache()
    slab_times, slab_bodies = check_slab_kernels(dev, cfg, checks, PULPoConfig(**OASIS))
    torch.cuda.empty_cache()
    slab2d_times, slab2d_bodies = check_slab_kernels_2d(
        dev, cfg_2d, checks, PULPoConfig(**dict(OASIS, input_size=cfg_2d.input_size)))
    slab_times.update(slab2d_times)
    if checks.failures:
        raise SystemExit(f"slab checks failed: {checks.failures}")
    torch.cuda.empty_cache()
    sp_root = pathlib.Path(tempfile.mkdtemp(prefix="pulpo_spatial_"))
    try:
        sp_counts, sp = run_spatial_paths(dev, sp_root)
        torch.cuda.empty_cache()
        sp2d_counts, sp2d = run_spatial_2d(dev, sp_root / "2d")
    finally:
        shutil.rmtree(sp_root, ignore_errors=True)
    torch.cuda.empty_cache()

    times = time_kernels(dev, full, level0, chunk, cfg.zdim, cfg.n0)
    times.update(time_backward_kernels(dev, cfg))
    times["warp_lungct"] = time_lungct_warp(dev, PULPoConfig(**LUNGCT).input_size)
    times.update(time_eval_kernels(dev, cfg, chunk, checks))
    if checks.failures:
        raise SystemExit(f"kernel checks failed: {checks.failures}")
    times.update(time_fullres_kernels(dev, PULPoConfig(**FLAGSHIP_FULLRES), fullres["chunk"]))
    times.update(time_training_shapes(dev))
    times.update(time_2d_kernels(dev, cfg_2d, uq2d["chunk"]))
    seg_times = time_seg_kernels(dev, PULPoConfig(**OASIS), cfg_2d)
    fig_warp = {what: time_warp_shapes(dev, info["seg_warps"])
                for what, info in (("figures", fig), ("figures_2d", fig2d))}
    for what, (per, total) in fig_warp.items():
        for shape, r in per.items():
            log(f"time {what} one-hot warp {shape}: {r['launches']} launches x {r['ms']:.4f} ms")
        log(f"time {what} path: the C = {SEG_CLASSES} one-hot warps {total:.3f} ms of device time")
    vxm_times = time_vxm_kernels(dev, FLAGSHIP["input_size"], VXM_SAMPLES)
    pairs, steps = vxm["pairs"], VXM_STEPS
    one, many = "1 rows", f"{VXM_SAMPLES} rows"
    vxm_path_ms = {
        "vxm_eval": {
            "conv_narrow": 3 * pairs * vxm_times["conv_narrow"]["2->16 f32"],
            "squaring": 7 * pairs * (2 * vxm_times["squaring"][one]
                                     + vxm_times["squaring"][many]),
            "warp": pairs * (2 * vxm_times["warp"][one] + vxm_times["warp"][many])},
        "vxm_train": {
            "conv_narrow": steps * vxm_times["conv_narrow"]["2->16 f32"],
            "squaring": 7 * steps * vxm_times["squaring"][one],
            "warp": steps * vxm_times["warp"][one],
            "squaring_bwd": 7 * steps * vxm_times["squaring_bwd"]["1 row"],
            "warp_dfgrad": steps * vxm_times["warp_dfgrad"]["1 row"]}}
    for k, shapes in vxm_times.items():
        log(f"time vxm {k}: " + ", ".join(f"{sh} {ms:.4f} ms" for sh, ms in shapes.items()))
    for path, per in vxm_path_ms.items():
        log(f"time {path} path device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    for k in ("squaring_cf", "warp_cf"):
        log(f"time {k} channels-last twin on the same field: {times[k]['cl_twin_ms']:.3f} ms "
            f"(CF {times[k]['ms']:.3f} ms)")
    r = times["warp_cf"]["mean_tail"]
    log(f"time warp_cf mean_tail {r['shape']}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms  "
        f"library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{r['bound_ms'] / r['ms']:.2f} of it)")
    for k in ("conv_narrow", "warp_dfgrad"):
        for shape, r in times[k]["shapes"].items():
            log(f"time {k} {shape}: device {r['ms']:.5f} ms ({r['bound_ms'] / r['ms']:.2f} of "
                f"its bound), eager {r['eager_ms']:.5f} ms  plain {r['plain_ms']:.3f} ms  "
                f"library {r['library_ms']:.5f} ms  bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})")
        for tag in ("flagship", "LungCT"):
            step = sum(r["ms"] for shape, r in times[k]["shapes"].items()
                       if shape.startswith(tag))
            log(f"time {k} a {tag} training step (one launch a shape): {step:.5f} ms")
    for shape, r in times["warp_dfgrad"]["shapes"].items():
        if "df_copy_ms" in r:
            log(f"time warp_dfgrad {shape}: the wrapper's copy of the step's strided df "
                f"{r['df_copy_ms']:.5f} ms")
    for l, r in times["pos_head"]["levels"].items():
        log(f"time pos_head l{l} {r['shape']}: kernel {r['ms']:.3f} ms ({r['tflop_per_s']:.1f} "
            f"TFLOP/s)  plain {r['plain_ms']:.3f} ms  library {r['library_ms']:.3f} ms  "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    for k in ("vel_head", "conv_chain"):
        r = times[k]
        log(f"{k} kernel {r['tflop_per_s']:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of its "
            f"bound")
    log(f"warp per voxel-row: LungCT ramp {times['warp_lungct']['ms'] * 1e9 / math.prod(LUNGCT['input_size']):.2f} ps, "
        f"3-voxel field {times['warp_lungct']['small_displacement_ms'] * 1e9 / math.prod(LUNGCT['input_size']):.2f} ps "
        f"(same shape), flagship 32 rows {times['warp']['ms'] * 1e9 / (chunk * math.prod(full)):.2f} ps")
    for k in ("squaring_2d", "warp_2d", "box_sum_2d"):
        r = times[k]
        lib = ("-" if r["library_ms"] is None else
               f"{r['library_ms']:.5f} ms (eager {r['library_eager_ms']:.5f} ms)")
        log(f"time {k} device (CUDA graph) {r['ms']:.5f} ms, eager {r['eager_ms']:.5f} ms; "
            f"library {lib}; bound {r['bound_ms']:.5f} ms")
    for k, r in times.items():
        log(f"time {k:12s} {r['shape']}: kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
            f"library {'-' if r['library_ms'] is None else format(r['library_ms'], '.3f')} ms  "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    kernels = []
    for name in KERNELS:
        r = times[name]
        by_path = {"serving": uq_counts[name], "serve": serve_counts[name],
                   "serving_fullres": fullres_counts[name],
                   "training": train_counts[name], "lungct_train": lungct_train[name],
                   "lungct_eval": lungct_eval[name], "serving_2d": uq2d_counts[name],
                   "training_2d": train2d_counts[name], "train_cli_2d": cli2d_counts[name],
                   "oasis_2d": oasis2d_counts[name], "serve_2d": serve2d_counts[name],
                   "oasis_train": oasis_train[name], "oasis_tables": oasis_eval[name],
                   "oasis_remat": remat_counts[name], "brats_train": brats_counts[name],
                   "figures": fig_counts[name], "figures_2d": fig2d_counts[name],
                   "vxm_eval": vxm["eval_counts"][name], "vxm_train": vxm["train_counts"][name],
                   "compare": cmp_counts[name], "native_oasis_train": native_counts[name],
                   "ingest": ingest_counts[name], "dp_step": dp_counts[name],
                   "train_cli_dp": cli_dp_counts[name],
                   # the flagship's bf16 sharded forward keeps its key
                   "spatial_forward": sp_counts["forward bfloat16"][name],
                   "spatial_forward_float32": sp_counts["forward float32"][name],
                   **{f"spatial_step_{d}": sp_counts[f"step {d}"][name] for d in STEP_DTYPES},
                   **{f"spatial_{n.replace(' ', '_')}": sp_counts[n][name]
                      for n, *_ in (*SEG_STEPS, *REMAT_STEPS)},
                   **{f"spatial_{n.replace(' ', '_')}": sp_counts[n][name]
                      for n in (*FULLRES_FORWARDS, FULLRES_STEP)},
                   "tp_forward": sp_counts["tp"][name],
                   **{f"spatial_{n.replace(' ', '_')}": c[name] for n, c in sp2d_counts.items()}}
        record = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": checks.worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        if name == "warp":
            record["lungct"] = {k: v for k, v in times["warp_lungct"].items() if k != "shape"}
        if name == "warp_cf":
            record["mean_tail"] = {k: v for k, v in r["mean_tail"].items() if k != "shape"}
        if name == "pos_head":
            record["levels"] = {l: {k: v for k, v in lv.items() if k != "shape"}
                                for l, lv in r["levels"].items()}
        if name in ("squaring_cf", "warp_cf"):
            record["cl_twin_ms"] = r["cl_twin_ms"]
        if name in ("conv_narrow", "warp_dfgrad"):
            record["shapes"] = r["shapes"]
        if name in seg_times:
            record[f"seg_c{SEG_CLASSES}"] = seg_times[name]
        if slab_times.get(name):
            record["slabs"] = slab_times[name]
        if name in vxm_times:
            record["vxm"] = {"ms": vxm_times[name],
                             "path_ms": {p: v[name] for p, v in vxm_path_ms.items() if name in v},
                             "library_ms": {k: v for k, v in vxm_times["library"].items()
                                            if k.startswith(name + " ")}}
        if name in ("warp", "warp_2d"):
            what = "figures" if name == "warp" else "figures_2d"
            per, total = fig_warp[what]
            record[f"{what}_c{SEG_CLASSES}"] = {"shapes": per, "path_ms": total}
        for k in ("eager_ms", "library_eager_ms"):
            if k in r:
                record[k] = r[k]
        kernels.append(record)
    log(f"serve: artifact {serve['bytes']} B, predict_deterministic {serve['det_s']:.3f} s, "
        f"predict_mean {serve['mean_s']:.3f} s, uq {' '.join(f'{t:.3f}' for t in serve['uq_s'])} s")
    for what, info in (("flagship", uq), ("flagship-fullres", fullres), ("flagship-2d", uq2d)):
        log(f"{what} UQ-{N_SAMPLES} requests {' '.join(f'{t:.5f}' for t in info['times'])} s "
            f"(warm {min(info['times'][1:]):.5f} s), peaks "
            f"{' '.join(f'{p:.2f}' for p in info['peaks'])} GiB, chunk {info['chunk']}")
    log(f"training step {train['step_s']:.3f} s, peak {train['peak_gib']:.2f} GiB")
    log(f"flagship-2d training step {train2d['step_s']:.5f} s, peak "
        f"{train2d['peak_gib']:.3f} GiB")
    log(f"lungct: Trainer step {lungct['step_s']:.3f} s, with validation and checkpoints "
        f"{lungct['step_with_io_s']:.3f} s, checkpoint {lungct['ckpt_bytes']} B in "
        f"{lungct['ckpt_s']:.3f} s, training peak {lungct['train_peak_gib']:.2f} GiB, "
        f"performance table {lungct['perf_s']:.3f} s, uncertainty table {lungct['unc_s']:.3f} s, "
        f"evaluation peak {lungct['eval_peak_gib']:.2f} GiB")
    log(f"serve 2D: artifact {serve2d['bytes']} B, predict_deterministic "
        f"{serve2d['det_s']:.4f} s, predict_mean {serve2d['mean_s']:.4f} s, uq "
        f"{' '.join(f'{t:.4f}' for t in serve2d['uq_s'])} s")
    log(f"oasis: Trainer step with segmentations {oasis['step_s']:.3f} s, iteration "
        f"{oasis['iteration_s']:.3f} s; without {oasis['plain_step_s']:.3f} s, iteration "
        f"{oasis['plain_iteration_s']:.3f} s; loader read {oasis['read_s']:.3f} s and pinned "
        f"copy {oasis['copy_s']:.3f} s a batch; training peak {oasis['train_peak_gib']:.2f} GiB; "
        f"tables {oasis['tables_s']:.3f} s, peak {oasis['eval_peak_gib']:.2f} GiB")
    log("remat B = 2 step: " + ", ".join(
        f"{k} peak {remat['peaks'][k]:.2f} GiB, {remat['times'][k]:.3f} s" for k in remat["peaks"])
        + f"; the plain step's gradient spread {remat['spread']:.3e}")
    log(f"brats: train_cli {BRATS_STEPS} steps with validation {brats['fit_s']:.2f} s")
    log(f"figures: evaluate_cli (visualize=True) {fig['fig_s']:.3f} s ({fig['figures']} "
        f"figures and the tables), run_one_model(visualize=False) {oasis['tables_s']:.3f} s, "
        f"peak {fig['peak_gib']:.2f} GiB; 2D {fig2d['fig_s']:.3f} s; validation panels "
        f"{panel_rounds} rounds")
    log(f"vxm: deterministic pair {vxm['det_ms']:.3f} ms, N = {VXM_SAMPLES} predict "
        f"{vxm['pred_ms']:.3f} ms (peak {vxm['pair_peak_gib']:.2f} GiB), training step "
        f"{vxm['step_ms']:.3f} ms (peak {vxm['train_peak_gib']:.2f} GiB); compare_models "
        f"{cmp['compare_s']:.3f} s")
    log(f"native loader (phase 10; {card}): read and one-hot {native['read_s']:.3f} s a batch, "
        f"iteration {native['iteration_s']:.3f} s (step {native['step_s']:.3f} s), the loader's "
        f"share {native['share']:.3f}; phase 8's h5py reader {oasis['read_s']:.3f} s a batch, "
        f"share {native['h5_share']:.3f}; launches at C = {SEG_CLASSES}: #4 "
        f"{native['c36']['warp']}, #6 {native['c36']['warp_dfgrad']}")
    log(f"ingest (phase 10b; {card}): {ingest['ms']:.3f} ms on the card, peak {ingest['peak_gib']:.3f} "
        f"GiB, {ingest['err']:.2e} of scale from the CPU")
    log(f"dp world 1 (phase 10c; {card}): step {dp['dp_step_s']:.3f} s, plain {dp['plain_step_s']:.3f} "
        f"s (phase 5b {train['step_s']:.3f} s); gradients "
        f"{'bit-equal' if dp['bit_equal'] else 'not bit-equal'} ({dp['rel']:.3e} relative L2, "
        f"the plain step's own spread {dp['spread']:.3e})")
    log(f"train_cli dp (phase 10d; {card}): {cli_dp['wall_s']:.1f} s for 2 processes")
    ref = sp["ref"]
    log(f"slab bodies at C = {SEG_CLASSES} and of the CF warp (phase 11; {card}): {slab_bodies}")
    log(f"spatial remat (phase 11e; {card}): " + "; ".join(
        f"{n}: gradients {x['grad_rel']:.3e} from the sharded plain step's (relative L2), "
        f"{x['recomputed_bytes'] / 1e6:.1f} of {x['bytes'] / 1e6:.1f} MB exchanged recomputed"
        for n, x in sp["remat"].items()) + f"; the plain step's run-to-run "
        f"{sp['remat_spread']:.3e}")
    log(f"spatial (phases 11a-11f; {card}): unsharded " + ", ".join(
            f"{n} {x['s']:.3f} s / {x['peak']:.3f} GiB" for n, x in ref.items()
            if isinstance(x, dict))
        + f", predict_deterministic {ref['tp_s']:.3f} s / {ref['tp_peak']:.3f} GiB"
        + "; per rank " + "; ".join(
            f"rank {i}: " + ", ".join(f"{p} {x['s']:.3f} s / {x['peak']:.3f} GiB"
                                      for p, x in r.items())
            for i, r in enumerate(sp["ranks"])) + f"; {sp['wall_s']:.1f} s for {SPACE} processes")
    log(f"slab bodies of the 2D warp (phase 11g; {card}): {slab2d_bodies}")
    log(f"spatial 2D (phase 11g; {card}): unsharded " + ", ".join(
            f"{n} {x['s']:.4f} s / {x['peak']:.3f} GiB" for n, x in sp2d["ref"].items())
        + "; per rank " + "; ".join(
            f"rank {i}: " + ", ".join(f"{p} {x['s']:.4f} s / {x['peak']:.3f} GiB"
                                      for p, x in r.items())
            for i, r in enumerate(sp2d["ranks"])) + f"; gradients " + ", ".join(
            f"{n} {x['grad_rel']:.3e} (relative L2)" for n, x in sp2d["steps"].items())
        + f"; {sp2d['wall_s']:.1f} s for {SPACE} processes")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 10d, under torchrun
        sys.exit(dp_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--spatial-worker"]:  # one rank of phases 11a-11f, under torchrun
        sys.exit(spatial_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--spatial-2d-worker"]:  # one rank of phase 11g, under torchrun
        sys.exit(spatial_2d_worker(*sys.argv[2:5]))
    sys.exit(main())
