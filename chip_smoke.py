#!/usr/bin/env python3
"""Smoke run of the PyTorch port (one2345_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: every CUDA kernel of the port, compiled by nvcc from the sources
   in the checkout (one process per source, all started together), with
   ptxas's registers, shared memory and spills for every instance; any
   spill fails the run;
3. kernels: the forward kernel against its plain PyTorch version at every
   shape the sampling path gives it and at two ragged shapes (16-byte and
   4-byte copies), then the two backward kernels against the plain
   backward at every shape the train step gives them and at the same two
   ragged shapes (bf16 N(0, 1) inputs from a seeded generator), and two
   launches of each at level 0 bit for bit; with the kernels', the plain
   versions' and one library call's times (CUDA events, after warm-up) and
   each kernel's bound on this card;
4. unet: one full-width Zero123-XL UNet eval (B=2) on the card (bf16, the
   kernels) against the same UNet on the CPU (f32, plain versions), with
   the same seeded weights and inputs;
5. grad: the gradients of one full-width level-0 SpatialTransformer (B=2,
   32x32 tokens) on the card (f32 weights, bf16 autocast, forward and
   backward kernels) against the CPU (f32, plain versions);
6. sampling: the image -> mesh path's four sampling phases at full width
   (stage 1 views 0-3, stage 2 of view 0, stage 1 of the second ring at the
   fallback polar angle of 90 degrees, stage 2 of the other 7 views), with
   seeded non-zero weights.  Run twice; launches are counted on the second;
7. elevation: LoFTR (ResNet-FPN 8_2, 4 + 1 linear-attention layer pairs,
   dual softmax, 5x5 fine windows, K=1024) at 480^2 with seeded weights on
   the 4 stage-2 views of view 0 of the warm sampling run: the card's f32
   matcher against the CPU's on one pair (backbone features, confidence
   matrix, the slates at the first threshold that keeps 64 matches), the
   view against itself (identity matches), the two-stage pose sweep on
   synthetic slates of a known elevation (73 degrees) on the card and the
   CPU, and ElevationEstimator.estimate with the bf16 matcher of
   PipelineConfig, cold and warm, with each pair's valid count;
8. recon: the reconstruction stage (ReconStage, lod0, ReconConfig() at
   full width, bf16 conv path) on the 32 stage-2 images of the warm
   sampling run and the rig's cameras at the same fallback polar angle:
   image stack -> 96^3 cost volume -> f32 256^3 field -> marching tets ->
   vertex colors, with seeded non-zero conv, BN and blending weights and
   the geometric SDF init (its latent columns seeded small).  One cold
   and one warm run, seconds per step; the mesh checked (finite, > 1000
   faces, indices in range, colors in [0, 1], warm equal to cold); the
   card's f32 stage against the CPU's (the conditional volume and the
   field at 64^3), and the bf16 field's signs against the f32 one's;
9. pipeline: the port's own entry point, One2345Pipeline(PipelineConfig())
   .run(skip_preprocess=True, output_format=".obj") on the weights of
   phases 6 to 8, once (phase 6 holds warm sampling against cold): seconds
   per span of the runner, the
   estimated elevation and the second ring it picked, 4000 K1 launches, the
   mesh checks of phase 8, every artifact (8 + 32 PNGs, pose.json,
   mesh.ply, mesh.obj) written (one PNG read back) and then removed;
10. preprocess: SAM ViT-H (width 1280, 16 heads, 1024^2) with seeded
   weights: at depth 2 (block 0 windowed, block 1 global) the card's f32
   stage against the CPU's (the embedding, the mask of one box prompt); the
   full SamConfig() in bf16 against f32 on the card; set_image cold, warm
   and memoised, predict_box, seed_bbox and the branch it took; thumbnail
   and recenter_rescale of a 2300x1700 image, RGBA and RGB (the RGB one
   box-reduced first), card against CPU bit for bit; check_safety with the
   f32 CLIP tower and seeded concept embeddings, thresholds just below and
   above the measured similarity, the same flags on card and CPU;
11. cli: pipeline.cli.main on a seeded 640x480 RGBA PNG written with the
   port's encoder (adaptive row filters: Sub, Up, Average and Paeth rows
   checked present) and read_png's host time on it and on a 2048x2048 RGBA
   photo (every row Paeth, and filtered adaptively); SAM on and the safety
   gate loaded (seeded embeddings that do not flag): run(skip_preprocess=False)
   at full width with the
   weights of phases 6 to 10, seconds per span, 4000 K1 launches, the mesh
   checks, every artifact and the input read back with the port's readers,
   then removed;
12. fast modes: cli.main on the same PNG with --sampler dpmpp --quant int8
   and with --sampler dpmpp (DPM-Solver++(2M) at 30 / 25 steps: 1792 K1
   launches each, the int8 GEMMs counted; spans against phase 11's DDIM
   run, the mesh checks, every artifact read back); one PLMS stage-1 call
   at 75 steps (1248 K1 launches); one quantized conv of each kind at level
   0 (3x3 640->320, the 1x1 skip, the stride-2 op; B=8) card against CPU:
   activation codes, scale and int32 accumulations equal bit for bit, the
   bf16 output within one rounding; the full-width int8 UNet (B=2) card
   against CPU, and against the card's bf16 UNet (the quantization error);
   the PLMS, DPM-Solver++ and img2img loops at [8, 32, 32, 4] card f32
   against CPU f32; int8 and bf16 UNet evals at B=8 and B=56 timed;
13. train: the Zero123 finetune step at full width (Zero123Trainer, B=8,
   remat, f32 weights, bf16 autocast): one cold step and five warm ones,
   each timed, its launches counted, and the first one's gradients, params
   and EMA checked;
14. recon train: reconstruction training on phase 9's warm scene (its
   stage1_8/, stage2_8/ and pose.json, kept under _smoke_scenes/) with
   seeded weights of the 8 networks (lod0 and lod1): (a) one
   ReconTrainer.scene_loss with its backward at lod0 and at lod1 on the
   card in f32 and on the CPU in f32 and float64, the same draws, at full
   widths but cut to 9 views, 48^3 / 96^3 volumes and 64 rays (running
   statistics card against CPU; the loss, metrics and every gradient card
   against the float64 reference, as accurate as the CPU's f32); (b) train_recon.main at full width (ReconConfig(
   num_lods=2): 33 views at 256^2, 96^3 then 192^3, 512 rays, f32): 4
   steps with validation at step 2 and checkpoints, seconds per step, peak
   memory, metrics.jsonl and the lod0 / lod1 panels read back, the
   checkpoint reloaded, --resume to a fifth step, one --num_lods 1 step;
   (c) the lod1 reconstruct (ReconStage(ReconConfig(num_lods=2)), R=256)
   on the trained weights cold and warm: seconds per span, the mesh
   checks, the pruned occupancy card against CPU, the depth-filtered
   pruning once with its depth maps card against CPU;
15. finetune: FinetuneTrainer (the per-shape -ft mode) at ReconConfig() on
   phase 14's scene with phase 8's lod0 weights: the conditional volume of
   the 32 source views, 20 steps of 512 rays cycling the 33 views (lr
   5e-4), seconds per step cold and warm, peak memory, every metric
   finite, the stage's 64^3 field and SDF MLP unchanged; the R=256 mesh of
   the finetuned volume and SDF MLP coloured by the finetuned blending net
   (the mesh checks of phase 8); one step's loss, metrics and every
   gradient on the card (f32) against a CPU float64 run at full widths cut
   to 9 source views, a 48^3 volume and 64 rays: within 1e-4 (metrics) and
   1e-3 (gradients, relative L2) or 4x the CPU f32's own error;
16. train_zero123: train_zero123.main at full width (DiffusionConfig(),
   --batch_size 8 --max_steps 4 --log_every 1 --ckpt_every 2
   --sample_every 2 --sample_views 4 --sample_steps 25) on phase 13's
   weights through --init_params, from 6 synthetic objects x 12 RGBA views
   at 300^2 (the port's PNG encoder; the LANCZOS resize runs) as folders
   and as two tar shards: seconds per step, samples/s, peak memory, K1 /
   dq / dkv launches equal to the code's count (32 / 16 / 16 per step, 16
   K1 per UNet eval of the grid), metrics.jsonl, the 768x1024 grid and the
   checkpoint (strict) read back; --model_shards 2 refused by create_mesh
   in a world of one;
17. eval: sweep.main --render_dir --clip_params (seeded ViT-L/14) on phase
   9's mesh as its own GT (.glb), against itself (.glb), a copy with each
   vertex moved 0.02 (.obj) and itself as .ply: the identical pair at the
   sampling floor (Chamfer-L2 < 1e-4), F-score 1, clip_sim 1 within 1e-5;
   the moved pair strictly worse; the .ply pair (8-bit colours read as
   [0, 1]) at clip_sim >= 0.99; 3 x 24 renders read back; one view
   rasterised on the card and the CPU, equal but at ties within 1e-9;
   seconds per pair and per 24 views;
18. convert: phase 11's weights written as the reference's checkpoint
   files (zero123-xl.ckpt as a Lightning LatentDiffusion file, the bare
   sam_vit_h_4b8939.pth, indoor_ds_new.ckpt under 'matcher.',
   ckpt_215000.pth with InPlaceABN gammas and torchsparse kernels, an HF
   safety-checker state dict) under _smoke_scenes/convert/, converted by
   utils/convert_cli.py in its own process into one parameter file, which
   reads back equal to phase 11's tree bit for bit; the UNet's EMA remap at
   full width in memory; cli.main --sampler dpmpp --params on that file
   (1792 K1 launches): the same stage images and mesh as phase 12's
   --sampler dpmpp run on the in-memory tree; seconds and bytes per file;
   the reference-format files stay for phase 24;
24. (after 18, its parts between 18 and 21, in 22 and after 23) surface:
   (a) examples/torch_validate_real_weights.py --skip_download on phase
   18's four files at torch's TF32 defaults: the conversion and its
   manifest, the golden DDIM run (4000 K1), the eval sweep skipped, the
   fast-mode A/B (dpmpp and dpmpp + int8: 1792 K1 each, one int8 GEMM per
   QConv2d and eval) with "weights": "converted" in fast_mode_ab.json;
   the same arguments with --dry_run skip the conversion by the manifest;
   (b) the CLI as a torchrun world of one over NCCL (python -m
   torch.distributed.run --nproc_per_node 1) with --params the converted
   file and --sampler dpmpp, ONE2345_COMPILE_CACHE a fresh directory
   holding copies of phase 2's libraries: it prints that directory, builds
   nothing there or in the checkout's, and its artifacts equal the A/B's
   dpmpp run byte for byte; (c) in phase 22's spawned world, after phase
   22's work: cli.main --sampler dpmpp --params on both gloo ranks (1792
   K1 on each, rank 0 alone writes), held to a one-card run that samples
   each batch in the ranks' two halves, then server.serve on both ranks
   (rank 0 on loopback, rank 1 following) with /preprocess,
   /estimate_elevation and /generate_mesh from a client thread (the mesh
   read back), stopped by SIGINT; (d) examples/torch_walkthrough.py and
   examples/torch_demo.py with --params on the card (4000 K1 each, their
   artifacts read back); seconds per part;
21. (after 18, before 19) multicard: the multi-card paths in a world of one
   over NCCL (tcp://localhost): (a) the sharded Zero123 step
   (make_sharded_train_step, FSDP2) at DiffusionConfig(), B=8, on a
   (data=1, model=1) mesh, two steps against the unsharded step from phase
   13's weights and draws (base lr 1e-2): losses within 1e-5, every
   update and EMA change within 5e-3 relative L2, K1 / dq / dkv 32 / 16 /
   16 per step; (b) the sharded reconstruction step at phase 14's full
   width against the unsharded one: metrics within 1e-4, no parameter
   element beyond 4 lr, at most 0.5% beyond 0.1 lr, running statistics
   within 1e-4; (c) Zero123Stage(mesh) stage 1 of views 0-3 and 4-11 (25
   DDIM entries) against the unsharded calls within 2e-3; (d)
   train_zero123.main --model_shards 1 and train_recon.main, two steps
   each in the group, their checkpoints read back;
22. gloo card: two gloo ranks on cuda:0 (spawned): the sharded
   reconstruction step at phase 14's cut config (both on its scene with
   the draws of an unsharded step, which they are held to as in (b)) and
   the sharded stage 1, held within 2e-3 to unsharded calls on each rank's
   own views (against phase 21's whole-batch images the bf16 UNet at
   another batch size differs by ~3e-2, printed);
23. recon bf16: train_recon.main --dtype bfloat16 --num_lods 2 at full
   width, 4 steps, seconds per step and peak memory beside phase 14's f32
   run; one bf16 scene_loss + backward at phase 14's cut config against
   phase 14's CPU float64 run, beside the card's f32 errors;
19. examples: the in-env quality examples' torch twins
   (examples/torch_*.py) on the card: the flash kernels against their
   plain versions at the examples' shapes (4 heads of D = 16 and 24, T = 16
   and 64, forward B = 8 / 12 / 56, backward B = 4 / 8 / 16); pipeline
   wiring tier A at 256^2 (polar 75 and 105, the flipped-azimuth control
   at 75); recon_quality, diffusion_quality (its tiny stage in bf16) and
   generative_e2e at the JAX tests' CI configurations with their gates
   (recon_quality and generative_e2e in a spawned second process while
   this one runs the others: each twin is host-bound on one core), each
   run's metrics on a line; the examples' K1, dq and dkv launches;
   ElevationEstimator.save_match_visualizations on phase 7's warm views,
   the six PNGs read back; seconds per part;
20. device times: each kernel's device time per launch (torch.profiler) at
   the shapes of phase 3, and the device time of SDPA's backward (the
   library yardstick of the backward kernels, with its kernels' names),
   after the timed phases 6 to 19, which a profiled run can slow on the
   host; then one warm reconstruct, one warm elevation estimate and one
   warm bf16 SAM encode under torch.profiler: device ms by kernel family
   (for SAM also the global blocks' share), the device's busy share, host
   ms of marching tets; one card QConv2d call of each kind (the integer
   GEMM inside its range, no conv kernel) and the int8 and bf16 UNet evals
   at B=8 and B=56: device ms by family, and the int8 GEMMs' and the
   quantize and dequantize passes' shares; last, one warm full-width lod1
   train step of phase 14: device ms by family, in its forward, backward
   and optimizer ranges, the backward's share, the busy share.

Then the kernels' JSON line (K1's launches are those of the CLI run, the
main path from a raw image; `launches_sharded` counts phase 21's sharded
steps and, for K1, its sharded sampler and phase 24's two ranks), the
nvidia-smi line, and the result line.
Needs one card; writes nothing outside its checkout (the pipeline's and
the CLI's files go to _smoke_out/, removed at the end of phases 9, 11 and
12; the training scene, the finetune, Zero123 and eval data and runs, the
reference-format files and phase 24's runs to _smoke_scenes/, removed
after phase 24).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet); a card set below
# 700 W runs slower, so every time is printed beside the power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# exp2 results per clock per SM on the special-function unit (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); the card's rate is this x SMs x its maximum SM clock
EXP2_PER_CLOCK_PER_SM = 16

O_TOL = 2e-2    # bf16 output, bf16 P in the P.V product
LSE_TOL = 1e-2  # f32 statistics from bf16 scores
# dQ, dK, dV: max abs error over max |ref| (bf16 P and dS in the products,
# bf16 outputs); 6.2e-3 at most on an H100 80GB HBM3 at 700 W
BWD_TOL = 1.5e-2
UNET_TOL = 5e-2  # relative L2, bf16 UNet against the f32 one
# relative L2 per parameter gradient, bf16 autocast against f32; 9.2e-3 at
# most on an H100 80GB HBM3 at 700 W
GRAD_TOL = 3e-2
POLAR_DEG = 90.0  # the runner's fallback elevation (ElevationConfig.default_elevation)
TRAIN_BATCH = 8
TRAIN_STEPS = 6  # one cold, five warm
RECON_RESOLUTION = 256  # ReconConfig().mesh_resolution
RECON_CHECK_RESOLUTION = 64  # the field lattice of the card-against-CPU check
VOLUME_TOL = 1e-3  # relative L2, f32 conditional volume, card against CPU
FIELD_TOL = 1e-3  # max abs, f32 field at 64^3, card against CPU
SIGN_AGREEMENT = 0.999  # bf16 field against the f32 one where |u| > 1e-2
RECON_SPANS = ("feature_maps", "conditional_volume", "field_grid", "field_to_host",
               "marching_tets", "colors")
# the elevation phase: card f32 LoFTR against CPU f32 on one pair at 480^2
LOFTR_FEATURE_TOL = 1e-3  # relative L2, coarse and fine backbone features
LOFTR_CONF_TOL = 1e-3  # relative L2, the dual-softmax confidence matrix
LOFTR_SET_AGREEMENT = 0.99  # shared valid (i, j) of the card's and CPU's slates, of the union
LOFTR_KPT_TOL = 1e-2  # px, fine keypoints of the shared entries
LOFTR_MIN_VALID = 64  # the check's threshold is the first of LOFTR_THRESHOLDS that keeps this many
LOFTR_THRESHOLDS = (0.05, 0.01, 0.001, 0.0)
SWEEP_GT = 73.0  # the synthetic slates' elevation (tests/test_elevation_solver.py)
SWEEP_TOL = 1e-4  # relative, the card's error curve against the CPU's
# the preprocess phase: SAM ViT-H at depth 2, card f32 against CPU f32, and
# the full encoder in bf16 against f32 on the card
SAM_EMBED_TOL = 1e-4  # relative L2 of the [1, 64, 64, 256] embedding
SAM_MASK_AGREEMENT = 0.999  # pixels of one box prompt's mask
SAM_BF16_TOL = 5e-2  # relative L2, bf16 embedding against the f32 one
PIPELINE_SPANS = ("preprocess", "stage1", "stage2_view0", "elevation", "stage2", "reconstruct")
# the fast-modes phase
INT8_OUT_TOL = 2**-8  # a quantized conv's bf16 output, card vs CPU, over max |ref|: one rounding
# relative L2, the int8 UNet card (bf16 compute) vs CPU (f32 compute): bf16
# rounding (1.5e-2 for the bf16 UNet) moves activations across rounding ties,
# and the layers after a flipped code land on other codes, so the two end up
# as far apart as int8 is from bf16 (5.6e-2 on these weights, and 5.8e-2 card
# vs CPU, NVIDIA H100 80GB HBM3, 700 W); every int8 layer of the eval is also
# replayed on the CPU from the card's own input, bit for bit
INT8_UNET_TOL = 0.1
SAMPLER_TOL = 1e-5  # relative L2, sampler and img2img update math, card f32 vs CPU f32
INT8_RANGES = ("int8_quantize", "int8_gemm", "int8_dequantize")  # QConv2d's profiler ranges
# (name, kernel, stride, padding, C_in, C_out) of the quantized convs checked at
# level 0 (32x32) on the CFG batch of 4 views: out_0_1_res.in_conv and .skip, down_0.op
INT8_CONVS = [("3x3", 3, 1, 1, 640, 320), ("1x1", 1, 1, 0, 640, 320), ("down", 3, 2, 1, 320, 320)]
DPMPP_EVALS = 31 + 25 + 31 + 25  # make_ddim_schedule(30) and (25) entries, stage 1, 2, 1, 2
PLMS_STAGE1_EVALS = 77 + 1  # make_ddim_schedule(75) entries and PLMS's Heun step
# the runner's outputs go here, inside the checkout (gitignored), and are
# removed at the end of the phase
PIPELINE_OUT = os.path.join(REPO, "_smoke_out")
# phase 9's warm scene (stage1_8/, stage2_8/, pose.json) under data/shape0/,
# the training runs' directories, the Zero123 data, the eval meshes and
# the reference-format checkpoints beside it (gitignored); removed after
# phase 18
SCENES_OUT = os.path.join(REPO, "_smoke_scenes")
# the recon train phase: the schedules' step of its card-against-CPU check
# (past every ramp and the fg/bg gate, so that every loss term counts)
RECON_TRAIN_STEP = 60_000
# its cuts, so that the CPU side stays well inside a minute, widths full:
# 9 of the 33 views (the reference and one source view per stage-1 view),
# 48^3 / 96^3 volumes in place of 96^3 / 192^3, 64 of the 512 rays
RECON_TRAIN_VIEWS = [0, 1, 5, 9, 13, 17, 21, 25, 29]
RECON_TRAIN_CHECK = dict(vol_dims=(48, 48, 48), voxel_size=2.0 / 47.0,
                         lod1_vol_dims=(96, 96, 96), lod1_voxel_size=2.0 / 95.0, n_rays=64)
# loss and metrics, relative, card f32 against the CPU float64 run: within
# RECON_LOSS_TOL or, where the CPU's own f32 is less accurate, within
# RECON_GRAD_FACTOR times its worst metric error (on phase 9's scene the
# CPU's f32 eikonal_lod1 was 8.3e-4 from float64, the card's 2.7e-4)
RECON_LOSS_TOL = 1e-4
# the sparsity terms, mean exp(-100 |sdf|), multiply an SDF difference by
# 100: sparse_loss_lod1 was 4.1e-4 from float64 on the card (the CPU's f32
# 5e-6) on a synthetic scene
RECON_SPARSE_TOL = 1e-3
RECON_STATS_TOL = 1e-5  # max abs, BN running statistics, card against CPU
# gradients: the cost's variance E[x^2] - E[x]^2 (the reference's formula)
# and batch norms over near-constant channels leave the feature path's
# gradients accurate to ~1e-2 in f32 on either device (CPU f32 against
# CPU f64 on this check's inputs: 8.7e-3 / 1.7e-2 worst at lod0 / lod1,
# where the card differed from the CPU by 1.3e-2 / 6.0e-2 and from itself
# by 1e-6), so the card's f32 gradients are held against a CPU float64
# run: each within RECON_GRAD_TOL relative L2 or, where the CPU's own f32
# is less accurate, within RECON_GRAD_FACTOR times its worst error; the
# global gradient the same way.  Floor: 1e-6 of the global norm.
RECON_GRAD_TOL = 1e-3
RECON_GRAD_FACTOR = 4.0
# phase 14's f32 figures (seconds per step, peak memory) and the float64
# reference of its lod1 check, which the bf16 phase prints its own beside
RECON_F32: dict = {}
RECON_REF: dict = {}
# the blend's softmax is shift invariant: these biases' true gradient is 0,
# held on both devices to the floor instead
ZERO_GRADS = ("render.rgb_fc2.bias", "render_lod1.rgb_fc2.bias")
RECON_LOD1_SPANS = ("feature_maps", "conditional_volume", "prune", "feature_maps_lod1",
                    "conditional_volume_lod1", "field_grid", "field_to_host", "marching_tets",
                    "colors")
TRAIN_PHASES = ("train_forward", "train_backward", "train_optimizer")
# the finetune phase: FinetuneTrainer at ReconConfig() on phase 14's scene
FT_STEPS = 20
FT_RAYS = 512
FT_LR = 5e-4
# its card-against-CPU step, cut so that the CPU's float64 run stays within
# seconds, widths full: 9 source views (one per stage-1 view and the last),
# a 48^3 volume, 64 rays of the reference view
FT_CHECK = dict(views=[1, 5, 9, 13, 17, 21, 25, 29, 32], vol_dims=(48, 48, 48),
                voxel_size=2.0 / 47.0, n_rays=64)
# the card's f32 loss and metrics against the CPU float64 run: within
# FT_LOSS_TOL relative or FT_FACTOR times the CPU f32's own worst error; its
# gradients within FT_GRAD_TOL relative L2 or FT_FACTOR times the CPU f32's
# worst (floor 1e-6 of the global norm), as phase 14 holds ReconTrainer's
FT_LOSS_TOL = 1e-4
FT_GRAD_TOL = 1e-3
FT_FACTOR = 4.0
# the train_zero123 phase: synthetic Objaverse renders, resized to 256^2
Z123_OBJECTS = 6
Z123_VIEWS = 12
Z123_SIZE = 300
Z123_STEPS = 4
Z123_SAMPLE_EVERY = 2
Z123_SAMPLE_STEPS = 25
# the eval phase
EVAL_MOVE = 0.02  # each vertex of the moved copy, in a seeded direction
# the identical pair's Chamfer-L2 is the floor of two 16384-point samplings
# (seeds 0 and 1) of one surface: ~1e-5 on a unit mesh
EVAL_SAME_CD = 1e-4
EVAL_CLIP_TOL = 1e-5  # the identical pair's clip_sim from 1
# the identical mesh as .ply: its colours truncated to 8 bits (up to 1/255
# off) and read back scaled by 1/255, so its renders are within 1/255 of the
# .glb's and its clip_sim near 1
EVAL_PLY_CLIP = 0.99
# the rasteriser card vs CPU: pixels may differ only at depth ties or
# pixel centres on an edge, within this (relative depth, barycentric)
RASTER_TIE = 1e-9

# the examples phase: the tiny Zero123 of the quality examples attends at its
# level 1 and middle block with 4 heads of D = 16 (model_channels 32, the CI
# configs) or 24 (48, the full-scale runs) over T = 16 (32^2 images) or 64
# (64^2) tokens; its forward batches are the CFG doubles of 4 views (stage
# 1), 6 held-out views and 28 views (stage 2), its backward batches the
# train batches 4, 8 and 16
EXAMPLE_HEADS = 4
EXAMPLE_ATTENTION = [(D, T) for D in (16, 24) for T in (16, 64)]
EXAMPLE_FWD_BATCHES = (8, 12, 56)
EXAMPLE_BWD_BATCHES = (4, 8, 16)
# the match figures of phase 7's warm views, read back and removed
MATCH_OUT = os.path.join(REPO, "_smoke_out", "match")

# (name, B, T=S, H, D) of every flash-attention call on the main path:
# level 0 at the CFG batch of 4 views (8) and of 28 views (56), then
# levels 1, 2 and the middle block at B=56
ATTENTION_SHAPES = [
    ("level0_b8", 8, 1024, 8, 40),
    ("level0_b56", 56, 1024, 8, 40),
    ("level1_b56", 56, 256, 8, 80),
    ("level2_b56", 56, 64, 8, 160),
    ("mid_b56", 56, 16, 8, 160),
]
HEADLINE_SHAPE = "level0_b56"  # the heaviest call: its numbers go in the JSON line
# (name, B, T, S, H, D, copy width in bytes) of the forward's ragged checks:
# T and S not multiples of the tiles, and D not a multiple of 8
RAGGED_SHAPES = [("ragged_16b", 2, 1000, 1000, 8, 40, 16), ("ragged_4b", 3, 77, 200, 4, 42, 4)]
# (name, T=S, D) of every attention backward of the train step (B=8, H=8)
TRAIN_SHAPES = [("level0", 1024, 40), ("level1", 256, 80), ("level2", 64, 160), ("mid", 16, 160)]
TRAIN_HEADLINE = "level0"
# parameters no loss reads: the one-token cross-attention is the broadcast
# of V, so its query and key projections and its pre-norm get no gradient,
# as in the JAX package (jax.grad gives them zeros)
DEAD = ("attn2.to_q.weight", "attn2.to_k.weight", "norm2.weight", "norm2.bias")


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PHASE_SECONDS: dict[str, float] = {}  # wall seconds of each phase, in order


def timed(name: str, phase, *args):
    """``phase(*args)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_us(evt) -> float:
    """Device time of a profiler row in microseconds (the attribute's name
    depends on the torch version)."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms_per_launch(fn, kernel: str, iters: int) -> tuple[float, int]:
    """(device ms per launch, recorded launches) of the kernel whose name
    contains ``kernel``: torch.profiler over ``iters`` calls of ``fn``, the
    kernel's device time over its recorded launches.  The profiler can drop
    records (on an H100 it kept 33 of 50 once), so a profiled run that
    recorded fewer than 0.9 * ``iters`` launches is made again, up to three
    runs in all.  Fails if none recorded that many, or if one recorded more
    than one launch per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if kernel in r.key and device_time_us(r) > 0]
        launches = sum(r.count for r in rows)
        if launches > iters:
            fail(f"profiler: {launches} launches of {kernel} recorded in {iters} calls")
        if launches >= 0.9 * iters:
            return sum(device_time_us(r) for r in rows) / launches / 1e3, launches
        counts.append(launches)
    fail(f"profiler: {counts} launches of {kernel} recorded in three profiled runs of {iters} calls")


def device_ms_per_call(fn, iters: int, exclude=()) -> tuple[float, list[str]]:
    """(device ms per call, names of the device kernels) of ``fn``: the sum
    of every kernel's and copy's device time in a torch.profiler run of
    ``iters`` calls, over the calls; ``exclude`` names record_function
    ranges, which the device timeline also lists and which are not work.
    A run that recorded fewer than 0.9 of the device events of ``iters``
    single-call runs is made again, up to three runs in all; fails if none
    did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in exclude]

    fn()
    torch.cuda.synchronize()
    per_call = len(run(1))
    counts = []
    for _ in range(3):
        events = run(iters)
        if per_call and len(events) >= 0.9 * per_call * iters:
            total_us = sum(e.device_time_total for e in events)
            return total_us / iters / 1e3, sorted({e.name for e in events})
        counts.append(len(events))
    fail(f"profiler: {counts} device events in three runs of {iters} calls ({per_call} per call)")


def kernel_bound(flops: float, nbytes: float, n_exp: float, exp_rate: float):
    """(ms, bound_by, terms): the least time the card could take for a
    kernel's work, the largest of its tensor-core operations at the bf16
    peak, its bytes (each input read once, each output written once) at the
    HBM rate, and its exp2 evaluations at the exp unit's rate; ``terms``
    holds all three in ms."""
    terms = {
        "operations": flops / PEAK_BF16_FLOPS * 1e3,
        "bytes": nbytes / PEAK_HBM_BYTES * 1e3,
        "exp": n_exp / exp_rate * 1e3,
    }
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def seeded_state_dict(module, seed: int) -> dict:
    """Non-zero f32 weights for ``module`` (built on the meta device):
    N(0, 1/fan_in) kernels, 1 + N(0, 0.1^2) norm scales, N(0, 0.1^2)
    biases and BN means, 1 + U(0, 0.5) BN variances, N(0, 0.02^2) CLIP
    embeddings.  Zero-initialised output convs would otherwise make every
    comparison check nothing."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        x = torch.randn(p.shape, generator=gen)
        if leaf in ("class_embedding", "positional_embedding"):
            x *= 0.02
        elif leaf in ("proj", "kernel"):  # used as x @ w: fan_in is dim 0
            x /= math.sqrt(p.shape[0])
        elif leaf == "weight" and p.dim() >= 2:
            x /= math.sqrt(p[0].numel())
        elif leaf == "weight":
            x = 1.0 + 0.1 * x
        elif leaf == "running_var":
            x = 1.0 + 0.5 * torch.rand(p.shape, generator=gen)
        else:
            x *= 0.1
        out[name] = x
    return out


def input_image(size: int = 256, seed: int = 0):
    """A synthetic object on white: a shaded disc, seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.ones((size, size, 3), np.float32)
    yy, xx = np.mgrid[:size, :size] / size
    disc = (yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.09
    shade = np.stack([yy, xx, 1.0 - yy], axis=-1) * 0.6 + 0.2
    img[disc] = (shade + 0.05 * rng.standard_normal(shade.shape))[disc].clip(0, 1)
    return img


TORCH_TF32_DEFAULTS = {}  # torch's TF32 flags before phase_device turns them off


def phase_device():
    import torch

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.stderr.strip()}")
    smi = res.stdout.strip().splitlines()[0]
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm: {res.stderr.strip()}")
    sm_mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = EXP2_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6
    # fp32 matmuls and cuDNN convs in full f32 (cuDNN defaults to TF32):
    # the plain versions here are references; phase 24 runs the entry
    # points at torch's own defaults, as a user's process has them
    TORCH_TF32_DEFAULTS.update(matmul=torch.backends.cuda.matmul.allow_tf32,
                               cudnn=torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"phase device: {smi} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda} | tf32 off | {sms} SMs, "
        f"max SM clock {sm_mhz:.0f} MHz: exp2 {exp_rate / 1e12:.3f}e12/s"
    )
    return smi, exp_rate


def phase_build():
    from one2345_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    spills = []
    for name in libs:
        entry = None
        for line in _build.build_log(name).splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            if "registers" in line or "spill" in line or found:
                log(f"  ptxas {name}: {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found and (int(found.group(1)) or int(found.group(2))):
                spills.append(f"{entry}: {line.strip()}")
    if spills:
        fail("ptxas spills registers in " + "; ".join(spills))
    log(
        f"phase build: {len(libs)} kernel(s) in {dt:.2f} s, no spills: {', '.join(sorted(libs))}"
    )


def check_forward(name: str, q, k, v):
    """The forward kernel against its plain version on the same bf16
    inputs: (max |O err|, max |lse err|); fails beyond O_TOL or LSE_TOL."""
    import torch

    from one2345_tpu_torch.ops.flash_attention import attention_reference, flash_attention

    o, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = attention_reference(q.float(), k.float(), v.float())
    err_o = float((o.float() - ref_o).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    if not (err_o <= O_TOL and err_lse <= LSE_TOL):
        fail(f"flash_attention {name}: O err {err_o} (<= {O_TOL}), lse err {err_lse} (<= {LSE_TOL})")
    return err_o, err_lse


def forward_inputs(i: int):
    """Seeded bf16 N(0, 1) q, k, v of ATTENTION_SHAPES[i], and its launches per timing."""
    import torch

    _, B, T, H, D = ATTENTION_SHAPES[i]
    gen = torch.Generator(device="cuda").manual_seed(100 + i)
    q, k, v = (
        torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    return q, k, v, 50 if B * T >= 8192 else 200


def backward_case(B: int, T: int, S: int, H: int, D: int, seed: int):
    """Seeded bf16 N(0, 1) q, k, v, dO, the forward kernel's o and lse, and Dsum."""
    import torch

    from one2345_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        for L in (T, S, S, T)
    )
    o, lse = fa.flash_attention(q, k, v)
    return q, k, v, do, o, lse, fa.softmax_grad_rowsum(o, do)


def backward_inputs(i: int):
    """backward_case of TRAIN_SHAPES[i] (B=TRAIN_BATCH, H=8), and the launches per timing."""
    _, T, D = TRAIN_SHAPES[i]
    return (*backward_case(TRAIN_BATCH, T, T, 8, D, seed=200 + i), 50 if T >= 1024 else 200)


def check_backward(name: str, q, k, v, do, o, lse, dsum):
    """The dq and dkv kernels against the plain backward on the same inputs:
    (errors over max |ref|, max abs errors) of dQ, dK, dV; fails beyond
    BWD_TOL."""
    import torch

    from one2345_tpu_torch.ops import flash_attention as fa

    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum)
    torch.cuda.synchronize()
    refs = fa.attention_backward_reference(q.float(), k.float(), v.float(), o, lse, do)
    abs_errs = [float((got.float() - ref).abs().max()) for got, ref in zip((dq, dk, dv), refs)]
    errs = [e / float(ref.abs().max()) for e, ref in zip(abs_errs, refs)]
    if not max(errs) <= BWD_TOL:
        fail(f"flash attention backward {name}: dq/dk/dv errors {errs} (<= {BWD_TOL})")
    return errs, abs_errs


def check_repeatable(name: str, q, k, v, do, lse, dsum):
    """Two launches of each backward kernel on the same inputs give
    bit-identical outputs (no atomics); fails otherwise."""
    import torch

    from one2345_tpu_torch.ops import flash_attention as fa

    runs = [
        (fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum),
         *fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum))
        for _ in range(2)
    ]
    torch.cuda.synchronize()
    for label, a, b in zip(("dq", "dk", "dv"), *runs):
        if not torch.equal(a, b):
            fail(f"flash attention backward {name}: two launches differ in {label}")


def phase_kernels(exp_rate: float):
    import torch
    import torch.nn.functional as F

    from one2345_tpu_torch.ops.flash_attention import (
        attention_reference,
        copy_bytes,
        flash_attention,
    )

    rows = {}
    for i, (name, B, T, H, D) in enumerate(ATTENTION_SHAPES):
        q, k, v, iters = forward_inputs(i)
        err_o, err_lse = check_forward(name, q, k, v)
        ms = time_ms(lambda: flash_attention(q, k, v), iters)
        plain_ms = time_ms(lambda: attention_reference(q, k, v), max(iters // 5, 10))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        flops = 4.0 * B * H * T * T * D
        nbytes = 4.0 * q.numel() * q.element_size() + B * H * T * 4  # Q, K, V, O; lse
        bound_ms, bound_by, terms = kernel_bound(flops, nbytes, B * H * T * T, exp_rate)
        rows[name] = dict(
            max_abs_err=err_o, lse_err=err_lse, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms, flops=flops,
        )
        log(
            f"phase kernels: flash_attention {name} B={B} T=S={T} H={H} D={D} "
            f"({copy_bytes(q, k, v)}-byte copies): "
            f"O err {err_o:.3e} (<= {O_TOL}) lse err {err_lse:.3e} (<= {LSE_TOL}) | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        )
    for i, (name, B, T, S, H, D, width) in enumerate(RAGGED_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(150 + i)
        q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (
            torch.randn(B, S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2)
        )
        if copy_bytes(q, k, v) != width:
            fail(f"flash_attention {name}: {copy_bytes(q, k, v)}-byte copies, expected {width}")
        err_o, err_lse = check_forward(name, q, k, v)
        rows[name] = dict(max_abs_err=err_o, lse_err=err_lse)
        log(
            f"phase kernels: flash_attention {name} B={B} T={T} S={S} H={H} D={D} "
            f"({width}-byte copies): O err {err_o:.3e} (<= {O_TOL}) lse err {err_lse:.3e} "
            f"(<= {LSE_TOL})"
        )
    return rows


def phase_kernels_bwd(exp_rate: float):
    """The dq and dkv kernels against the plain backward at the train
    step's shapes and at the ragged shapes, from the forward kernel's o and
    lse."""
    from one2345_tpu_torch.ops import flash_attention as fa

    rows = {}
    B, H = TRAIN_BATCH, 8
    for i, (name, T, D) in enumerate(TRAIN_SHAPES):
        q, k, v, do, o, lse, dsum, iters = backward_inputs(i)
        errs, abs_errs = check_backward(name, q, k, v, do, o, lse, dsum)
        repeat = ""
        if name == TRAIN_HEADLINE:
            check_repeatable(name, q, k, v, do, lse, dsum)
            repeat = " | two launches bit-identical"
        dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum), iters)
        dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum), iters)
        plain_dq_ms = time_ms(lambda: fa.dq_reference(q, k, v, do, lse, dsum), max(iters // 5, 10))
        plain_dkv_ms = time_ms(lambda: fa.dkv_reference(q, k, v, do, lse, dsum), max(iters // 5, 10))
        # yardstick: the backward alone of PyTorch's fused attention (dQ, dK
        # and dV in one call), same inputs and dtype
        sdpa_ms = time_ms(sdpa_backward(q, k, v, do), iters)
        n = q.numel() * q.element_size()  # one [B, T, H, D] bf16 tensor
        stats = 2 * B * H * T * 4  # lse and dsum, f32 [B, H, T]
        row = {}
        for kernel, flops, nbytes, ms, plain_ms, err in (
            ("dq", 6.0 * B * H * T * T * D, 5 * n + stats, dq_ms, plain_dq_ms, abs_errs[0]),
            ("dkv", 8.0 * B * H * T * T * D, 6 * n + stats, dkv_ms, plain_dkv_ms,
             max(abs_errs[1:])),
        ):
            # one exp2 per score in each kernel (P recomputed from lse)
            bound_ms, bound_by, terms = kernel_bound(flops, nbytes, B * H * T * T, exp_rate)
            row[kernel] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms, flops=flops,
            )
        rows[name] = row
        log(
            f"phase kernels: flash_attention backward {name} B={B} T=S={T} H={H} D={D} "
            f"({fa.copy_bytes(q, k, v, do)}-byte copies): "
            f"dq/dk/dv err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} of max |ref| (<= {BWD_TOL}), "
            f"abs {abs_errs[0]:.3e}/{abs_errs[1]:.3e}/{abs_errs[2]:.3e} | "
            f"dq {dq_ms:.4f} ms (bound {row['dq']['bound_ms']:.4f}, {row['dq']['bound_by']}, "
            f"plain {plain_dq_ms:.4f}) | "
            f"dkv {dkv_ms:.4f} ms (bound {row['dkv']['bound_ms']:.4f}, {row['dkv']['bound_by']}, "
            f"plain {plain_dkv_ms:.4f}) | sdpa backward {sdpa_ms:.4f} ms{repeat}"
        )
    for i, (name, B, T, S, H, D, width) in enumerate(RAGGED_SHAPES):
        q, k, v, do, o, lse, dsum = backward_case(B, T, S, H, D, seed=250 + i)
        if fa.copy_bytes(q, k, v, do) != width:
            fail(f"flash attention backward {name}: {fa.copy_bytes(q, k, v, do)}-byte copies, "
                 f"expected {width}")
        errs, abs_errs = check_backward(name, q, k, v, do, o, lse, dsum)
        rows[name] = {"dq": dict(max_abs_err=abs_errs[0]), "dkv": dict(max_abs_err=max(abs_errs[1:]))}
        log(
            f"phase kernels: flash_attention backward {name} B={B} T={T} S={S} H={H} D={D} "
            f"({width}-byte copies): dq/dk/dv err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} of "
            f"max |ref| (<= {BWD_TOL})"
        )
    return rows


def sdpa_backward(q, k, v, do):
    """One call of the backward alone of PyTorch's fused attention on these
    [B, T, H, D] inputs (dQ, dK and dV in one torch.autograd.grad): the
    backward kernels' library yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves))
    grad_out = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)


def phase_device_times(rows: dict, bwd_rows: dict):
    """Every kernel's device time per launch (torch.profiler) at every
    main-path and train-step shape, on the inputs of phase 3.  It runs
    after the timed phases: a profiled run can leave every later
    launch in the process costing more host time, and the B=8 sampling
    phases and the train step are host-bound."""
    from one2345_tpu_torch.ops import flash_attention as fa

    for i, (name, B, T, H, D) in enumerate(ATTENTION_SHAPES):
        q, k, v, iters = forward_inputs(i)
        ms, recorded = device_ms_per_launch(
            lambda: fa.flash_attention(q, k, v), "flash_fwd_kernel", iters
        )
        row = rows[name]
        row["device_ms"] = ms
        log(
            f"phase device times: flash_attention {name} B={B} T=S={T} H={H} D={D}: "
            f"device {ms:.4f} ms/launch ({recorded} of {iters} launches recorded), "
            f"{row['flops'] / ms / 1e9:.1f} TFLOP/s, {row['bound_ms'] / ms:.2f} of the bound"
        )
    for i, (name, T, D) in enumerate(TRAIN_SHAPES):
        q, k, v, do, _, lse, dsum, iters = backward_inputs(i)
        for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
            ms, recorded = device_ms_per_launch(
                lambda: fn(q, k, v, do, lse, dsum), f"flash_bwd_{kernel}_kernel", iters
            )
            row = bwd_rows[name][kernel]
            row["device_ms"] = ms
            log(
                f"phase device times: flash_attention backward {kernel} {name} B={TRAIN_BATCH} "
                f"T=S={T} H=8 D={D}: device {ms:.4f} ms/launch ({recorded} of {iters} launches "
                f"recorded), {row['flops'] / ms / 1e9:.1f} TFLOP/s, "
                f"{row['bound_ms'] / ms:.2f} of the bound"
            )
        sdpa_ms, names = device_ms_per_call(sdpa_backward(q, k, v, do), iters)
        for kernel in ("dq", "dkv"):
            bwd_rows[name][kernel]["library_device_ms"] = sdpa_ms
        log(
            f"phase device times: sdpa backward {name} B={TRAIN_BATCH} T=S={T} H=8 D={D}: "
            f"device {sdpa_ms:.4f} ms/call (event {bwd_rows[name]['dq']['library_ms']:.4f} ms) | "
            f"dq + dkv device {bwd_rows[name]['dq']['device_ms'] + bwd_rows[name]['dkv']['device_ms']:.4f} ms"
            f" | kernels: {'; '.join(names)}"
        )


def phase_unet():
    import torch

    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.unet import cast_compute
    from one2345_tpu_torch.diffusion.zero123 import make_unet
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    u = DiffusionConfig().unet
    with torch.device("meta"):
        shapes = make_unet(u)
    weights = seeded_state_dict(shapes, seed=1)
    with torch.device("meta"):
        cpu_unet = make_unet(u)
    cpu_unet.load_state_dict(weights, strict=True, assign=True)
    with torch.device("cuda"):
        gpu_unet = make_unet(u)
    gpu_unet.load_state_dict(weights, strict=True)
    cast_compute(gpu_unet, torch.bfloat16)

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 32, 32, u.in_channels, generator=gen)
    t = torch.tensor([977, 421])
    ctx = torch.randn(2, 1, u.context_dim, generator=gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_unet(x, t, ctx)
    cpu_s = time.perf_counter() - t0
    flash_attention.launch_count = 0
    with torch.inference_mode():
        out = gpu_unet(x.cuda(), t.cuda(), ctx.cuda())
    torch.cuda.synchronize()
    launches = flash_attention.launch_count
    rel = float(torch.linalg.vector_norm(out.cpu() - ref) / torch.linalg.vector_norm(ref))
    if not torch.isfinite(out).all() or rel > UNET_TOL:
        fail(f"full-width UNet on the card vs CPU: relative L2 {rel} (<= {UNET_TOL})")
    if launches != 16:
        fail(f"full-width UNet eval launched flash_attention {launches} times, expected 16")
    log(
        f"phase unet: full-width UNet B=2 card bf16 vs CPU f32: relative L2 {rel:.3e} "
        f"(<= {UNET_TOL}), |ref| rms {float(ref.pow(2).mean().sqrt()):.3e}, "
        f"flash_attention launches {launches}, CPU eval {cpu_s:.1f} s"
    )
    return weights


def phase_grad():
    """Gradients of one full-width level-0 SpatialTransformer: the card (f32
    weights, bf16 autocast, the forward and backward kernels) against the
    CPU (f32, plain versions), same seeded weights and inputs."""
    import torch

    from one2345_tpu_torch.diffusion.unet import SpatialTransformer
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    C, heads, ctx_dim, B, L = 320, 8, 768, 2, 32
    with torch.device("meta"):
        shapes = SpatialTransformer(C, ctx_dim, heads, 1)
    weights = seeded_state_dict(shapes, seed=5)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(B, C, L, L, generator=gen)
    ctx = torch.randn(B, 1, ctx_dim, generator=gen)
    w = torch.randn(B, C, L, L, generator=gen)  # the loss is sum(out * w)
    grads, launches = {}, None
    for device in ("cpu", "cuda"):
        with torch.device("meta"):
            module = SpatialTransformer(C, ctx_dim, heads, 1)
        module = module.to_empty(device=device)
        module.load_state_dict(weights, strict=True)
        f = flash_attention
        f.launch_count = f.dq_launch_count = f.dkv_launch_count = 0
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=device == "cuda"):
            out = module(x.to(device), ctx.to(device))
        (out.float() * w.to(device)).sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()
            launches = (f.launch_count, f.dq_launch_count, f.dkv_launch_count)
        grads[device] = {
            k: None if p.grad is None else p.grad.float().cpu()
            for k, p in module.named_parameters()
        }
    if launches != (1, 1, 1):
        fail(f"SpatialTransformer fwd/dq/dkv launches {launches}, expected (1, 1, 1)")
    rels = {}
    for k, ref in grads["cpu"].items():
        got = grads["cuda"][k]
        if k.endswith(DEAD):
            if ref is not None or got is not None:
                fail(f"SpatialTransformer: {k} should get no gradient")
            continue
        if got is None or not torch.isfinite(got).all():
            fail(f"SpatialTransformer: {k} gradient missing or not finite on the card")
        rels[k] = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    for k in ("block0.attn1.to_q.weight", "block0.attn1.to_k.weight", "block0.attn1.to_v.weight"):
        if not float(grads["cuda"][k].abs().max()) > 0:
            fail(f"SpatialTransformer: {k} gradient is zero on the card")
    worst = max(rels, key=rels.get)
    if rels[worst] > GRAD_TOL:
        fail(f"SpatialTransformer: {worst} gradient relative L2 {rels[worst]} (> {GRAD_TOL})")
    attn1 = max(v for k, v in rels.items() if ".attn1." in k)
    log(
        f"phase grad: full-width level-0 SpatialTransformer B={B} T={L * L} C={C}: "
        f"{len(rels)} parameter gradients, card bf16 autocast vs CPU f32 relative L2 "
        f"worst {rels[worst]:.3e} ({worst}), attn1 worst {attn1:.3e} (<= {GRAD_TOL}); "
        f"{len(grads['cpu']) - len(rels)} unread parameters without gradient on both; "
        f"fwd/dq/dkv launches {launches}"
    )


def run_main_path(stage, image, timer):
    """The runner's four sampling phases (One2345Pipeline.run, with the
    elevation estimate pinned to its fallback)."""
    import torch

    with timer.span("stage1"):
        s1_first = stage.stage1(image, seed=1, indices=[0, 1, 2, 3])
    with timer.span("stage2_view0"):
        s2_v0 = stage.stage2(s1_first[:1], seed=2, view_ids=[0])
    second_ring = [4, 5, 6, 7] if POLAR_DEG <= 75 else [8, 9, 10, 11]
    with timer.span("stage1_ring2"):
        s1_second = stage.stage1(image, seed=3, indices=second_ring)
    stage1_images = torch.cat([s1_first, s1_second])
    with timer.span("stage2_rest"):
        rest = stage.stage2(stage1_images[1:], seed=4, view_ids=list(range(1, 8)))
    return stage1_images, torch.cat([s2_v0, rest])


def build_stage(unet_weights):
    """The full-width Zero123 stage on the card with seeded weights, and the
    f32 state dicts it was built from."""
    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage

    t0 = time.perf_counter()
    shapes = Zero123Stage(DiffusionConfig(), device="meta")
    params = {"unet": unet_weights}
    for i, name in enumerate(("encoder", "decoder", "clip", "cc_projection")):
        params[name] = seeded_state_dict(getattr(shapes, name), seed=10 + i)
    stage = Zero123Stage(DiffusionConfig(), params=params, device="cuda")
    log(f"stage built with seeded weights in {time.perf_counter() - t0:.1f} s")
    return stage, params


def phase_sampling(stage, smi):
    import torch

    from one2345_tpu_torch.core.profiling import Timer, unet_flops_per_eval
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    image = input_image(stage.config.image_size)
    evals = {"stage1": 76, "stage2_view0": 49, "stage1_ring2": 76, "stage2_rest": 49}
    batch = {"stage1": 8, "stage2_view0": 8, "stage1_ring2": 8, "stage2_rest": 56}
    flops = sum(n * unet_flops_per_eval(batch[k]) for k, n in evals.items())
    expected = 16 * sum(evals.values())
    first = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        timer = Timer(device="cuda")
        flash_attention.launch_count = 0
        s1, s2 = run_main_path(stage, image, timer)
        torch.cuda.synchronize()
        launches = flash_attention.launch_count
        if tuple(s1.shape) != (8, 256, 256, 3) or tuple(s2.shape) != (8, 4, 256, 256, 3):
            fail(f"sampling shapes {tuple(s1.shape)} {tuple(s2.shape)}")
        for name, imgs in (("stage1", s1), ("stage2", s2)):
            if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 1:
                fail(f"{name} images not finite in [0, 1]")
        if launches != expected:
            fail(f"flash_attention launched {launches} times on the main path, expected {expected}")
        spans = timer.report()
        total = timer.total()
        inside = float(((s2 > 0.01) & (s2 < 0.99)).float().mean())
        rerun = "" if first is None else f", max |warm - cold| {float((s2 - first).abs().max()):.3e}"
        first = s2
        log(
            f"phase sampling ({run}): "
            + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
            + f", total {total:.3f} s | UNet {flops / 1e12:.1f} TFLOP, "
            f"MFU {flops / total / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s | "
            f"flash_attention launches {launches} (expected {expected}) | "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
            f"stage2 pixels in (0.01, 0.99) {inside:.3f}{rerun} | {smi}"
        )
    return launches, s2


def loftr_weights(seed: int) -> dict:
    """``seeded_state_dict`` weights of the full-width LoFTR modules (BN
    statistics included)."""
    import torch

    from one2345_tpu_torch.elevation.loftr import LoFTRModules

    with torch.device("meta"):
        shapes = LoFTRModules()
    return seeded_state_dict(shapes, seed)


def rel_l2(a, b) -> float:
    import torch

    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def slate_entries(res, wc: int) -> dict:
    """{(i, j) coarse cells: fine kpts1} of the valid entries of a one-pair
    slate."""
    k0, k1, valid = (x[0].cpu() for x in (res.kpts0, res.kpts1, res.valid))
    i = (k0[:, 1] // 8) * wc + k0[:, 0] // 8
    j = (k1[:, 1] / 8).round() * wc + (k1[:, 0] / 8).round()
    return {(int(a), int(b)): k1[n] for n, (a, b) in enumerate(zip(i, j)) if valid[n]}


def synthetic_slates(gt: float, K, n: int = 64, kpad: int = 1024, noise: float = 0.3,
                     seed: int = 3):
    """The six match slates of ``n`` points seen from the 4 poses of
    elevation ``gt``, with pixel noise, padded with invalid entries to
    ``kpad`` (the recipe of tests/test_elevation_solver.py)."""
    import numpy as np
    import torch

    from one2345_tpu_torch.elevation.solver import PAIRS, pose_hypothesis

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.25, 0.25, size=(n, 3))
    poses = pose_hypothesis(torch.tensor(gt)).double().numpy()

    def project(pose):
        w2c = np.linalg.inv(pose)
        uv = (pts @ w2c[:3, :3].T + w2c[:3, 3][None]) @ K.T
        return uv[:, :2] / uv[:, 2:3]

    projs = [project(poses[i]) for i in range(4)]
    k0 = np.zeros((len(PAIRS), kpad, 2), np.float32)
    k1 = np.zeros((len(PAIRS), kpad, 2), np.float32)
    conf = np.zeros((len(PAIRS), kpad), np.float32)
    valid = np.zeros((len(PAIRS), kpad), bool)
    for p, (i, j) in enumerate(PAIRS):
        k0[p, :n] = projs[i] + rng.normal(0, noise, (n, 2))
        k1[p, :n] = projs[j] + rng.normal(0, noise, (n, 2))
        conf[p, :n] = 1.0
        valid[p, :n] = True
    return tuple(torch.from_numpy(x) for x in (k0, k1, conf, valid))


def phase_elevation(views, smi):
    """LoFTR and the elevation solver at full width on the 4 stage-2 views
    of view 0: (a) the card's f32 matcher against the CPU's on one pair at
    480^2 (features, confidence, slates); (b) the view against itself;
    (c) the two-stage sweep on synthetic slates of a known elevation, card
    against CPU; (d) ElevationEstimator.estimate with the bf16 matcher of
    PipelineConfig, cold and warm.  Returns (LoFTR weights, the bf16
    estimator) for the pipeline phase and the profiled call of phase 11."""
    import numpy as np
    import torch

    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.elevation import loftr, solver

    weights = loftr_weights(seed=60)
    gray = solver.grayscale_480(views.float().cpu())  # [4, 480, 480], both devices' input
    matchers = {dev: loftr.LoFTRMatcher(weights, device=dev) for dev in ("cuda", "cpu")}
    out, times = {}, {}
    for dev, m in matchers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coarse, fine = m.extract(gray[:2].to(dev))
        c0, c1, conf = m.coarse_confidence(coarse[:1], coarse[1:])
        torch.cuda.synchronize()
        times[dev] = time.perf_counter() - t0
        out[dev] = (coarse, fine, conf)
    rels = [rel_l2(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    if not (rels[0] <= LOFTR_FEATURE_TOL and rels[1] <= LOFTR_FEATURE_TOL
            and rels[2] <= LOFTR_CONF_TOL):
        fail(f"LoFTR card f32 vs CPU f32 relative L2 coarse/fine/conf {rels} "
             f"(<= {LOFTR_FEATURE_TOL}, {LOFTR_FEATURE_TOL}, {LOFTR_CONF_TOL})")
    wc = out["cpu"][0].shape[2]
    card = matchers["cuda"]
    for thr in LOFTR_THRESHOLDS:
        card.threshold = thr
        res = card.match_features(out["cuda"][0], out["cuda"][1], [0], [1])
        n_valid = int(res.valid.sum())
        if n_valid >= LOFTR_MIN_VALID:
            break
    else:
        fail(f"LoFTR slate keeps {n_valid} valid matches at threshold {thr} (< {LOFTR_MIN_VALID})")
    matchers["cpu"].threshold = thr
    res_cpu = matchers["cpu"].match_features(out["cpu"][0], out["cpu"][1], [0], [1])
    a = slate_entries(res, wc)
    b = slate_entries(res_cpu, wc)
    shared = a.keys() & b.keys()
    agree = len(shared) / max(len(a.keys() | b.keys()), 1)
    kpt_err = max((float((a[k] - b[k]).abs().max()) for k in shared), default=0.0)
    if not (agree >= LOFTR_SET_AGREEMENT and kpt_err <= LOFTR_KPT_TOL):
        fail(f"LoFTR slates card vs CPU: shared (i, j) {agree} of the union (>= "
             f"{LOFTR_SET_AGREEMENT}), fine keypoints max abs {kpt_err} (<= {LOFTR_KPT_TOL})")
    # (b) the view against itself: valid matches are identity correspondences
    same = card.match_pair(gray[0].cuda(), gray[0].cuda())
    n_same = int(same.valid.sum())
    if n_same == 0:
        fail(f"LoFTR: a view against itself kept no match at threshold {thr}")
    off = float((same.kpts0[same.valid] - same.kpts1[same.valid]).abs().max())
    if off > 8.0:
        fail(f"LoFTR: a view against itself matched {off} px off the identity (> 8)")
    log(
        f"phase elevation: LoFTR f32 at 480^2 full width, seeded weights, card vs CPU on views "
        f"(0, 1) of view 0: relative L2 coarse {rels[0]:.3e}, fine {rels[1]:.3e} (<= "
        f"{LOFTR_FEATURE_TOL}), confidence {rels[2]:.3e} (<= {LOFTR_CONF_TOL}), max conf "
        f"{float(out['cpu'][2].max()):.4f}; slates at threshold {thr}: {n_valid} valid on the "
        f"card, {int(res_cpu.valid.sum())} on the CPU, shared (i, j) {agree:.4f} of the union "
        f"(>= {LOFTR_SET_AGREEMENT}), fine keypoints max abs {kpt_err:.3e} px (<= "
        f"{LOFTR_KPT_TOL}); view against itself {n_same} valid, max |kpts0 - kpts1| "
        f"{off:.3f} px (<= 8); card {times['cuda']:.3f} s, CPU {times['cpu']:.2f} s"
    )

    # (c) the two-stage sweep on synthetic slates, card against CPU
    K = np.array([[280.0, 0, 128], [0, 280.0, 128], [0, 0, 1]], np.float32)
    packed = synthetic_slates(SWEEP_GT, K)
    elevs = torch.arange(30.0, 150.0, 1.0)
    curves, ests = {}, {}
    for dev in ("cuda", "cpu"):
        Kt = torch.from_numpy(K).to(dev)
        p = tuple(x.to(dev) for x in packed)
        curves[dev] = solver._sweep(elevs.to(dev), Kt, p, len(solver.PAIRS)).cpu()
        ests[dev] = float(solver._sweep_two_stage(Kt, p, len(solver.PAIRS)))
    curve_err = float((curves["cuda"] - curves["cpu"]).abs().max() / curves["cpu"].abs().max())
    if not (abs(ests["cuda"] - SWEEP_GT) <= 2.0 and ests["cuda"] == ests["cpu"]
            and curve_err <= SWEEP_TOL):
        fail(f"elevation sweep on synthetic slates at {SWEEP_GT}: card {ests['cuda']}, CPU "
             f"{ests['cpu']}, error curves {curve_err} apart (<= {SWEEP_TOL})")

    # (d) the estimator as PipelineConfig builds it (bf16 matcher)
    ecfg = PipelineConfig().elevation
    m16 = loftr.LoFTRMatcher(weights, dtype=ecfg.dtype, device="cuda")
    est = solver.ElevationEstimator(m16, focal=ecfg.focal, image_size=ecfg.image_size)
    c16, _ = m16.extract(gray[:2].cuda())
    _, _, conf16 = m16.coarse_confidence(c16[:1], c16[1:])
    rel16 = rel_l2(conf16, out["cuda"][2])
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        elev = est.estimate(views)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = [int(v.sum()) for _, _, _, v in est.match_views(views)]
    log(
        f"phase elevation: two-stage sweep on synthetic slates (K=1024, 64 valid, 0.3 px "
        f"noise) at {SWEEP_GT}: card {ests['cuda']}, CPU {ests['cpu']}, error curves (30-149 "
        f"by 1) max rel {curve_err:.3e} (<= {SWEEP_TOL}) | ElevationEstimator.estimate, bf16 "
        f"matcher at threshold {m16.threshold}: cold {secs[0]:.4f} s, warm {secs[1]:.4f} s, "
        f"valid per pair {counts}, estimate {elev} | bf16 vs f32 confidence relative L2 "
        f"{rel16:.3e} | {smi}"
    )
    del matchers, out
    return weights, est


def phase_pipeline(zero123_params, recon_p, loftr_w, smi):
    """One2345Pipeline(PipelineConfig()).run at full width on one card, with
    the seeded weights of phases 6 to 8, once (cold; phase 6 holds warm
    sampling against cold, bit for bit): seconds per span, the elevation
    and the ring it picked, K1 launches, the mesh, the artifacts (read
    back), peak memory.  Returns the mesh (for the eval phase)."""
    import shutil

    import numpy as np
    import torch

    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.ops.flash_attention import flash_attention
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline
    from one2345_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    pipe = One2345Pipeline(
        PipelineConfig(), params={"zero123": zero123_params, "recon": recon_p, "loftr": loftr_w},
        use_sam=False, device="cuda",
    )
    _ = pipe.zero123, pipe.recon, pipe.elevation_estimator
    log(f"phase pipeline: One2345Pipeline(PipelineConfig()) built with seeded weights in "
        f"{time.perf_counter() - t0:.1f} s")
    image = input_image()
    expected = 16 * (76 + 49 + 76 + 49)
    try:
        run = "cold"  # one run: phase 6 holds warm against cold
        out_dir = os.path.join(PIPELINE_OUT, run)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.run(image, out_dir=out_dir, skip_preprocess=True, seed=0,
                       output_format=".obj")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launch_count
        if launches != expected:
            fail(f"pipeline {run}: flash_attention launched {launches} times, expected "
                 f"{expected}")
        if tuple(res.timings) != PIPELINE_SPANS:
            fail(f"pipeline {run}: spans {tuple(res.timings)}, expected {PIPELINE_SPANS}")
        for name, imgs in (("stage1", res.stage1_images), ("stage2", res.stage2_images)):
            if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 1:
                fail(f"pipeline {run}: {name} images not finite in [0, 1]")
        check_mesh(f"pipeline {run}", {"vertices": res.vertices, "faces": res.faces,
                                       "colors": res.colors})
        polar = 90.0 - res.elevation
        sel = list(range(8)) if polar <= 75 else [0, 1, 2, 3, 8, 9, 10, 11]
        want = {f"stage1_8/{i}.png" for i in sel}
        want |= {f"stage2_8/{i}_{j}.png" for i in sel for j in range(4)}
        want |= {"pose.json", "mesh.ply", "mesh.obj"}
        have = {
            os.path.relpath(os.path.join(d, f), out_dir)
            for d, _, files in os.walk(out_dir) for f in files
        }
        if have != want or res.mesh_path != os.path.join(out_dir, "mesh.obj"):
            fail(f"pipeline {run}: artifacts {sorted(have ^ want)} differ from the expected "
                 f"{len(want)}, mesh path {res.mesh_path}")
        k = 5
        png = read_png(os.path.join(out_dir, "stage1_8", f"{sel[k]}.png"))
        ref = (res.stage1_images[k].cpu().numpy() * 255).astype(np.uint8)
        if not np.array_equal(png, ref):
            fail(f"pipeline {run}: stage1_8/{sel[k]}.png does not read back as its image")
        log(
            f"phase pipeline ({run}): " + ", ".join(
                f"{k} {v:.4f} s" for k, v in res.timings.items())
            + f", total {total:.4f} s | elevation {res.elevation} (polar {polar}), second "
            f"ring {sel[4:]} | flash_attention launches {launches} (expected {expected}) | "
            f"{len(res.vertices)} vertices, {len(res.faces)} faces | {len(have)} artifacts "
            f"({len(sel)} stage-1 PNGs, {4 * len(sel)} stage-2 PNGs, pose.json, mesh.ply, "
            f"mesh.obj), stage1_8/{sel[k]}.png read back equal | peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}"
        )
        # the run's scene, as train_recon reads it, for phase 14
        shutil.rmtree(SCENES_OUT, ignore_errors=True)
        shape = os.path.join(SCENES_OUT, "data", "shape0")
        os.makedirs(shape)
        for name in ("stage1_8", "stage2_8"):
            shutil.copytree(os.path.join(out_dir, name), os.path.join(shape, name))
        shutil.copy(os.path.join(out_dir, "pose.json"), shape)
    finally:
        shutil.rmtree(PIPELINE_OUT, ignore_errors=True)
    log("phase pipeline: output directory removed")
    return {"vertices": res.vertices, "faces": res.faces, "colors": res.colors}


def sam_input(h: int, w: int, seed: int, rgba: bool):
    """A seeded object (a shaded ellipse with texture) on white, or on a
    transparent ground for RGBA, as uint8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    obj = ((yy - 0.52 * h) / (0.3 * h)) ** 2 + ((xx - 0.47 * w) / (0.27 * w)) ** 2 < 1
    img = np.full((h, w, 4), 255, np.uint8)
    shade = np.stack([yy / h, xx / w, 1.0 - yy / h], axis=-1) * 150 + 40
    img[obj, :3] = (shade[obj] + rng.normal(0, 12, (int(obj.sum()), 3))).clip(0, 255)
    if rgba:
        img[..., 3] = np.where(obj, 255, 0)
        return img
    return np.ascontiguousarray(img[..., :3])


def sam_weights(seed: int) -> dict:
    """Seeded non-zero f32 weights of the full SamModules (ViT-H)."""
    from one2345_tpu_torch.core.config import SamConfig
    from one2345_tpu_torch.segmentation.sam import SamStage

    return seeded_state_dict(SamStage(SamConfig(), device="meta").modules, seed)


class RecordingChecker:
    """A SafetyChecker that keeps the embeddings it is asked about."""

    def __init__(self, checker):
        self.checker, self.seen = checker, []

    @property
    def has_weights(self):
        return self.checker.has_weights

    def check(self, emb):
        self.seen.append(emb)
        return self.checker.check(emb)


def phase_preprocess(zero123_params, smi):
    """Preprocessing at full width with seeded weights: SAM ViT-H at depth 2
    (block 0 windowed, block 1 global) card f32 against CPU f32, the full
    encoder in bf16 against f32 on the card, set_image cold / warm,
    predict_box, seed_bbox; the PIL / OpenCV resizes card against CPU; the
    safety gate's flags card against CPU.  Returns the bf16 stage, its f32
    weights and the image, for the CLI phase and the profile."""
    import types

    import numpy as np
    import torch

    from one2345_tpu_torch.core.config import PipelineConfig, SamConfig
    from one2345_tpu_torch.diffusion.clip import CLIPVisionTower
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline
    from one2345_tpu_torch.segmentation.safety import SafetyChecker
    from one2345_tpu_torch.segmentation.sam import SamStage
    from one2345_tpu_torch.utils import image as img_utils
    weights = sam_weights(seed=41)
    rgb = sam_input(384, 512, seed=42, rgba=False)  # a 512-thumbnail frame
    box = (100, 60, 420, 330)

    # depth 2 at full width: card f32 (TF32 off) against CPU f32
    cfg2 = SamConfig(encoder_depth=2, global_attn_indexes=(1,), dtype="float32")
    w2 = seeded_state_dict(SamStage(cfg2, device="meta").modules, seed=47)
    stages, caches, masks, secs = {}, {}, {}, {}
    for dev in ("cpu", "cuda"):
        stages[dev] = SamStage(cfg2, params=w2, device=dev)
        t0 = time.perf_counter()
        caches[dev] = stages[dev].set_image(rgb)
        masks[dev] = stages[dev].predict_box(caches[dev], box)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    emb_rel = rel_l2(caches["cuda"]["embedding"], caches["cpu"]["embedding"])
    agree = float((masks["cuda"] == masks["cpu"]).mean())
    if not emb_rel <= SAM_EMBED_TOL or not agree >= SAM_MASK_AGREEMENT:
        fail(f"preprocess: SAM depth 2 card vs CPU: embedding relative L2 {emb_rel:.3e} (<= "
             f"{SAM_EMBED_TOL}), mask agreement {agree:.6f} (>= {SAM_MASK_AGREEMENT})")
    log(
        f"phase preprocess: SAM ViT-H width 1280, 16 heads, depth 2 (block 0 windowed, block 1 "
        f"global) at 1024^2, seeded, f32: card vs CPU embedding [1, 64, 64, 256] relative L2 "
        f"{emb_rel:.3e} (<= {SAM_EMBED_TOL}), box-prompt mask ({masks['cpu'].mean():.4f} of "
        f"{rgb.shape[1]}x{rgb.shape[0]}) agreement {agree:.6f} (>= {SAM_MASK_AGREEMENT}); "
        f"set_image + predict_box cold: card {secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s"
    )
    del stages, caches

    # the full encoder: bf16 against f32, both on the card
    t0 = time.perf_counter()
    f32 = SamStage(SamConfig(dtype="float32"), params=weights, device="cuda")
    bf16 = SamStage(SamConfig(), params=weights, device="cuda")
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    e32 = f32.set_image(rgb)["embedding"]
    del f32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for run in range(2):
        bf16._memo = None  # a cold and a warm encode of the same image
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = bf16.set_image(rgb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    memo = bf16.set_image(rgb)
    memo_s = time.perf_counter() - t0
    if memo is not cache:
        fail("preprocess: set_image did not return the memoised encoding")
    e16 = cache["embedding"]
    bf_rel = rel_l2(e16, e32)
    if not torch.isfinite(e16).all() or not bf_rel <= SAM_BF16_TOL:
        fail(f"preprocess: bf16 SAM embedding vs f32 relative L2 {bf_rel:.3e} (<= {SAM_BF16_TOL})")
    t0 = time.perf_counter()
    mask = bf16.predict_box(cache, box)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seed = bf16.seed_bbox(cache)
    seed_s = time.perf_counter() - t0
    branch = f"SAM's box {seed}" if seed is not None else (
        f"None -> estimate_bbox {img_utils.estimate_bbox(rgb)}")
    log(
        f"phase preprocess: full SamConfig() (32 blocks, global 7/15/23/31, bf16) built in "
        f"{built:.1f} s; vs the f32 encoder on the card: relative L2 {bf_rel:.3e} (<= "
        f"{SAM_BF16_TOL}); set_image cold {times[0]:.4f} s, warm {times[1]:.4f} s, memoised "
        f"{memo_s * 1e3:.3f} ms; predict_box warm {predict_s:.4f} s (mask {mask.mean():.4f} of "
        f"the frame); seed_bbox {seed_s:.4f} s: {branch}; peak mem of the encodes {peak:.2f} GiB "
        f"| {smi}"
    )

    # the resizes of thumbnail and recenter_rescale, card against CPU
    lines = []
    for rgba in (True, False):
        big = sam_input(1700, 2300, seed=43, rgba=rgba)
        outs = {}
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            thumb = img_utils.thumbnail(big, 512, device=dev)
            t1 = time.perf_counter()
            out = img_utils.recenter_rescale(thumb if rgba else np.concatenate(
                [thumb, np.full(thumb.shape[:2] + (1,), 255, np.uint8)], -1), device=dev)
            outs[dev] = (thumb, out, t1 - t0, time.perf_counter() - t1)
        (ta, oa, *_), (tb, ob, *_) = outs["cpu"], outs["cuda"]
        if not np.array_equal(ta, tb) or not np.array_equal(oa, ob):
            fail(f"preprocess: thumbnail / recenter_rescale of 2300x1700 "
                 f"{'RGBA' if rgba else 'RGB'} differ between card and CPU")
        lines.append(
            f"{'RGBA' if rgba else 'RGB (box-reduced by 2 first)'} -> {tb.shape[1]}x{tb.shape[0]} "
            f"thumbnail card {outs['cuda'][2]:.4f} s / CPU {outs['cpu'][2]:.4f} s, recenter "
            f"card {outs['cuda'][3]:.4f} s / CPU {outs['cpu'][3]:.4f} s")
    log("phase preprocess: 2300x1700 " + "; ".join(lines) + ": card equal to CPU, bit for bit")

    # the safety gate: f32 CLIP ViT-L/14 on both, thresholds around the
    # measured similarity (x 1.2 in the checker)
    concept = np.random.default_rng(44).standard_normal((2, 768)).astype(np.float32)
    flags, sims = {}, {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            tower = CLIPVisionTower()
        tower.load_state_dict(zero123_params["clip"], strict=True)
        pipe = One2345Pipeline(PipelineConfig(), device=dev)
        pipe._zero123 = types.SimpleNamespace(clip=tower.eval())
        probe = RecordingChecker(SafetyChecker(concept, np.zeros(2, np.float32)))
        pipe._safety = probe
        pipe.check_safety(rgb)
        emb = probe.seen[0][0]
        sims[dev] = (concept @ emb) / (np.linalg.norm(concept, axis=1) * np.linalg.norm(emb))
        # concept 0's threshold 0.02 below the card's similarity, concept
        # 1's 0.02 above (the checker scales thresholds by 1.2)
        thresholds = (sims["cuda"] + np.array([-0.02, 0.02])) / 1.2
        flags[dev] = []
        for k in range(2):
            t = np.full(2, 10.0, np.float32)
            t[k] = thresholds[k]
            pipe._safety = SafetyChecker(concept, t)
            flags[dev].append(pipe.check_safety(rgb))
        del tower, pipe
    if flags["cuda"] != flags["cpu"] or flags["cuda"] != [True, False]:
        fail(f"preprocess: safety flags card {flags['cuda']}, CPU {flags['cpu']}, expected "
             f"[True, False]")
    log(
        f"phase preprocess: check_safety (f32 CLIP ViT-L/14, PIL-bicubic 224 input), cosine "
        f"similarities card {np.round(sims['cuda'], 6).tolist()}, CPU "
        f"{np.round(sims['cpu'], 6).tolist()}; thresholds 0.02 below / above concept 0 and 1: "
        f"flags card {flags['cuda']} = CPU {flags['cpu']}"
    )

    # One2345Pipeline.preprocess warm, step by step, on a 640x480 RGBA
    # input: the bf16 SAM stage above, the bf16 CLIP tower, a gate that
    # does not flag
    from one2345_tpu_torch.diffusion.unet import cast_compute

    with torch.device("cuda"):
        tower = CLIPVisionTower()
    tower.load_state_dict(zero123_params["clip"], strict=True)
    pipe = One2345Pipeline(PipelineConfig(), device="cuda")
    pipe._zero123 = types.SimpleNamespace(clip=cast_compute(tower.eval(), torch.bfloat16))
    pipe._safety = SafetyChecker(concept, np.full(2, 0.9, np.float32))
    pipe._sam = bf16
    raw = sam_input(480, 640, seed=45, rgba=True)
    pipe.preprocess(raw)  # warm
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    bf16._memo = None
    thumb = step("thumbnail", lambda: img_utils.thumbnail(raw, 512, device="cuda"))
    rgb2 = step("composite", lambda: (img_utils.composite_white(
        thumb.astype(np.float32) / 255.0) * 255).astype(np.uint8))
    step("check_safety", lambda: pipe.check_safety(rgb2))
    cache = step("set_image", lambda: bf16.set_image(rgb2))
    box2 = step("seed_bbox", lambda: bf16.seed_bbox(cache))
    mask2 = step("predict_box", lambda: bf16.predict_box(
        cache, box2 if box2 is not None else img_utils.estimate_bbox(rgb2)))
    rgba2 = np.concatenate([rgb2, (mask2[..., None] * 255).astype(np.uint8)], axis=-1)
    step("recenter_rescale", lambda: img_utils.recenter_rescale(rgba2, device="cuda"))
    bf16._memo = None
    step("preprocess (whole)", lambda: pipe.preprocess(raw))
    log("phase preprocess: One2345Pipeline.preprocess warm on a 640x480 RGBA image, by step (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in steps.items()) + f" | {smi}")
    del pipe, tower
    return bf16, weights, rgb


def png_photo(h: int, w: int, seed: int):
    """A seeded photo-like RGBA frame: smooth shading with sensor noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    shade = np.stack([128 + 100 * np.sin(xx / 300) * np.cos(yy / 200),
                      40 + 180 * xx / w, 60 + 150 * yy / h], axis=-1)
    img = np.full((h, w, 4), 255, np.uint8)
    img[..., :3] = (shade + rng.normal(0, 6, (h, w, 3))).clip(0, 255)
    return img


def png_read_seconds(read, expected) -> float:
    """The best of three host times of ``read()``, whose result must equal
    ``expected``."""
    import numpy as np

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = read()
        best = min(best, time.perf_counter() - t0)
        if not np.array_equal(out, expected):
            fail("png: a decoded file differs from the image written")
    return best


def cli_input():
    """The seeded 640x480 RGBA input of the CLI phases, written with the
    port's encoder to _smoke_out/input.png; returns (path, image)."""
    from one2345_tpu_torch.utils.png import write_png

    os.makedirs(PIPELINE_OUT, exist_ok=True)
    img_path = os.path.join(PIPELINE_OUT, "input.png")
    raw = sam_input(480, 640, seed=45, rgba=True)
    write_png(img_path, raw)
    return img_path, raw


def cli_params(params, sam_w):
    """The CLI's parameter tree: the stages' seeded weights, SAM's, and the
    safety gate of ``safety_state_dict()`` (seeded concept and special-care
    embeddings that do not flag)."""
    from one2345_tpu_torch.segmentation.safety import SafetyChecker

    sd = safety_state_dict()
    safety = SafetyChecker(sd["concept_embeds"], sd["concept_embeds_weights"],
                           sd["special_care_embeds"], sd["special_care_embeds_weights"])
    return dict(params, sam=sam_w, safety=safety)


def cli_run(name: str, flags: list, img_path: str, raw, params, expected: int):
    """pipeline.cli.main on the input PNG with ``flags`` at full width, SAM
    on: K1 launches (``expected``), the spans, the mesh, every artifact and
    the input read back.  Returns (result, call seconds, K1 launches, the
    artifacts' count, pose entries, peak GiB); the output directory is
    removed."""
    import json as json_mod
    import shutil

    import numpy as np
    import torch

    from one2345_tpu_torch.ops.flash_attention import flash_attention
    from one2345_tpu_torch.pipeline import cli
    from one2345_tpu_torch.recon.mesh_extract import load_ply
    from one2345_tpu_torch.utils.png import read_png

    out_dir = os.path.join(PIPELINE_OUT, "cli")
    try:
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(["--img_path", img_path, "--out_dir", out_dir, "--output_format", ".obj",
                        *flags], params=params)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launch_count
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != expected:
            fail(f"{name}: flash_attention launched {launches} times, expected {expected}")
        if tuple(res.timings) != PIPELINE_SPANS or not res.timings["preprocess"] > 0:
            fail(f"{name}: spans {res.timings}, expected {PIPELINE_SPANS}")
        check_mesh(name, {"vertices": res.vertices, "faces": res.faces, "colors": res.colors})
        polar = 90.0 - res.elevation
        sel = list(range(8)) if polar <= 75 else [0, 1, 2, 3, 8, 9, 10, 11]
        want = {f"stage1_8/{i}.png" for i in sel}
        want |= {f"stage2_8/{i}_{j}.png" for i in sel for j in range(4)}
        want |= {"pose.json", "mesh.ply", "mesh.obj"}
        have = {os.path.relpath(os.path.join(d, f), out_dir)
                for d, _, files in os.walk(out_dir) for f in files}
        if have != want or res.mesh_path != os.path.join(out_dir, "mesh.obj"):
            fail(f"{name}: artifacts {sorted(have ^ want)} differ, mesh path {res.mesh_path}")
        s1 = (res.stage1_images.cpu().numpy() * 255).astype(np.uint8)
        s2 = (res.stage2_images.cpu().numpy() * 255).astype(np.uint8)
        for k, i in enumerate(sel):
            ok = np.array_equal(read_png(os.path.join(out_dir, "stage1_8", f"{i}.png")), s1[k])
            for j in range(4):
                ok &= np.array_equal(read_png(os.path.join(out_dir, "stage2_8", f"{i}_{j}.png")),
                                     s2[k, j])
            if not ok:
                fail(f"{name}: the PNGs of view {i} do not read back as their images")
        with open(os.path.join(out_dir, "pose.json")) as f:
            pose = json_mod.load(f)
        v, faces, _ = load_ply(os.path.join(out_dir, "mesh.ply"))
        if not np.array_equal(v, res.vertices.astype(np.float32)) or not np.array_equal(faces, res.faces):
            fail(f"{name}: mesh.ply does not read back as the mesh")
        with open(os.path.join(out_dir, "mesh.obj")) as f:
            kinds = [line[:2] for line in f]
        if kinds.count("v ") != len(res.vertices) or kinds.count("f ") != len(res.faces):
            fail(f"{name}: mesh.obj does not hold the mesh")
        if not np.array_equal(read_png(img_path), raw):
            fail(f"{name}: the input PNG does not read back")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return res, total, launches, len(have), len(pose), peak


def cli_line(res, total: float, launches: int, expected: int, n_files: int, n_pose: int,
             peak: float) -> str:
    polar = 90.0 - res.elevation
    return (
        ", ".join(f"{k} {v:.4f} s" for k, v in res.timings.items())
        + f", total {total:.4f} s | elevation {res.elevation} (polar {polar}) | "
        f"flash_attention launches {launches} (expected {expected}) | {len(res.vertices)} "
        f"vertices, {len(res.faces)} faces | {n_files} artifacts and the input read back "
        f"({n_pose} pose entries) | peak mem {peak:.2f} GiB"
    )


def phase_cli(params, sam_w, smi):
    """The CLI on a seeded 640x480 RGBA PNG written with the port's encoder:
    pipeline.cli.main([...]) with SAM on and the safety gate loaded (seeded
    embeddings that do not flag), i.e. run(skip_preprocess=False) at full
    width: spans, K1 launches, the mesh, every artifact read back.  Returns
    the K1 launches."""
    import shutil

    import numpy as np

    from one2345_tpu_torch.utils.png import decode_png, encode_png, read_png, row_filters

    expected = 16 * (76 + 49 + 76 + 49)
    try:
        img_path, raw = cli_input()
        with open(img_path, "rb") as f:
            rows = np.bincount(row_filters(f.read()), minlength=5)
        if not (rows[1:] > 0).all():
            fail(f"cli: the input PNG's rows by filter type {rows.tolist()} lack Sub, Up, "
                 "Average or Paeth")
        read_s = png_read_seconds(lambda: read_png(img_path), raw)
        photo = png_photo(2048, 2048, seed=47)
        photo_s = {}
        paeth, adaptive = encode_png(photo, filter_type=4), encode_png(photo)
        for kind, data in (("Paeth", paeth), ("adaptive", adaptive)):
            photo_s[kind] = png_read_seconds(lambda: decode_png(data), photo)  # noqa: B023
        run = cli_run("cli", [], img_path, raw, cli_params(params, sam_w), expected)
        log(
            f"phase cli: read_png of the 640x480 RGBA input (rows None/Sub/Up/Average/Paeth "
            f"{rows.tolist()}): {read_s * 1e3:.2f} ms; decode_png of a 2048x2048 RGBA photo, "
            f"every row Paeth: {photo_s['Paeth'] * 1e3:.2f} ms, filtered adaptively: "
            f"{photo_s['adaptive'] * 1e3:.2f} ms (best of 3, host) | {smi}"
        )
        log(
            "phase cli: one2345_tpu_torch.pipeline.cli.main on a 640x480 RGBA PNG (SAM on, "
            "safety gate loaded: 3 seeded concepts, no flag): "
            + cli_line(*run[:3], expected, *run[3:]) + f" | {smi}"
        )
    finally:
        shutil.rmtree(PIPELINE_OUT, ignore_errors=True)
    return run


def quantized_conv_pair(name: str, k: int, stride: int, padding: int, cin: int, cout: int):
    """A seeded conv of INT8_CONVS as a CPU QConv2d and a card one (bf16
    outputs), and its bf16 input [8, C_in, 32, 32] on the CPU."""
    import torch

    from one2345_tpu_torch.diffusion.quantize import QConv2d

    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=padding)
    conv.load_state_dict(seeded_state_dict(conv, seed=60 + k + stride))
    cpu, card = QConv2d.from_float(conv), QConv2d.from_float(conv).cuda()
    cpu.dtype = card.dtype = torch.bfloat16
    x = torch.randn(8, cin, 32, 32, generator=torch.Generator().manual_seed(61 + cin)).bfloat16()
    return conv, cpu, card, x


def int8_unet(state, device: str, dtype):
    """The full-width int8 UNet of a quantized state on ``device``."""
    import torch

    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.unet import cast_compute
    from one2345_tpu_torch.diffusion.zero123 import make_unet

    with torch.device("meta"):
        unet = make_unet(DiffusionConfig().unet, quant=True)
    unet = unet.to_empty(device=device)
    unet.load_state_dict(state, strict=True)
    return cast_compute(unet, dtype).eval()


def sampler_math(device: str) -> dict:
    """The PLMS, DPM-Solver++ and img2img loops at the full latent shape
    [8, 32, 32, 4] on ``device`` in f32, driven by eps = 0.3 x + 0.1 tanh(x)
    + c[t] with a seeded table c: {name: (output, UNet evals)}."""
    import numpy as np
    import torch

    from one2345_tpu_torch.diffusion import img2img
    from one2345_tpu_torch.diffusion.dpm_solver import dpmpp_sample
    from one2345_tpu_torch.diffusion.plms import plms_sample
    from one2345_tpu_torch.diffusion.schedule import make_ddim_schedule

    rng = np.random.default_rng(70)
    table = torch.from_numpy((0.2 * rng.standard_normal((1000, 32, 32, 4))).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((8, 32, 32, 4)).astype(np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal((51, 8, 32, 32, 4)).astype(np.float32)).to(device)
    evals = []

    def eps(v, t):
        evals.append(t)
        return 0.3 * v + 0.1 * torch.tanh(v) + table[t]

    def run(fn):
        evals.clear()
        return fn(), len(evals)

    eta0, eta1 = make_ddim_schedule(50, eta=0.0), make_ddim_schedule(50, eta=1.0)
    return {
        "plms 75 (77 entries)": run(lambda: plms_sample(eps, x, make_ddim_schedule(75, eta=0.0))),
        "dpmpp 30 (31 entries)": run(lambda: dpmpp_sample(eps, x, make_ddim_schedule(30, eta=0.0))),
        "dpmpp 25 (25 entries)": run(lambda: dpmpp_sample(eps, x, make_ddim_schedule(25, eta=0.0))),
        "ddim_encode 50, t_enc 30": run(lambda: img2img.ddim_encode(eps, x, eta0, 30)),
        "stochastic_encode 50, t [0, 7, ..., 49]": run(lambda: img2img.stochastic_encode(
            x, [0, 7, 14, 21, 28, 35, 42, 49], eta0, noise[0])),
        "ddim_decode 50 eta 1, t_start 30": run(lambda: img2img.ddim_decode(
            eps, x, eta1, 30, noise_fn=lambda d, shape: noise[d])),
    }


def phase_fast_modes(stage, unet_weights, params, sam_w, ddim_run, smi):
    """The CLI's fast modes at full width, unprofiled (the profile of the
    int8 UNet comes last, in phase_fast_modes_profile): the CLI from the
    phase-11 PNG with --sampler dpmpp --quant int8 and with --sampler dpmpp,
    one PLMS stage-1 call, the quantized convs and the int8 UNet card
    against CPU, the sampler update math card against CPU, and the int8 and
    bf16 UNet evals timed.  Returns the card's int8 UNet and the --sampler
    dpmpp run (``cli_run``'s result)."""
    import shutil

    import torch

    from one2345_tpu_torch.diffusion import quantize as q
    from one2345_tpu_torch.diffusion.zero123 import STAGE1_DELTA_X, STAGE1_DELTA_Y
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    # the CLI, first: the timed runs before any profiled one
    expected = 16 * DPMPP_EVALS
    ddim_res, ddim_total = ddim_run[0], ddim_run[1]
    n_qconv = None
    runs = {}
    try:
        img_path, raw = cli_input()
        for flags in (["--sampler", "dpmpp", "--quant", "int8"], ["--sampler", "dpmpp"]):
            q.int8_matmul.launch_count = 0
            run = runs[" ".join(flags)] = cli_run(
                "fast modes cli " + " ".join(flags), flags, img_path, raw,
                cli_params(params, sam_w), expected)
            gemms = q.int8_matmul.launch_count
            if "int8" in flags:
                n_qconv = gemms // DPMPP_EVALS
                if n_qconv * DPMPP_EVALS != gemms or n_qconv < 1:
                    fail(f"fast modes: {gemms} int8 GEMMs in {DPMPP_EVALS} UNet evals")
            elif gemms:
                fail(f"fast modes: {gemms} int8 GEMMs without --quant int8")
            res, total = run[0], run[1]
            sampling = sum(res.timings[k] for k in ("stage1", "stage2_view0", "stage2"))
            ddim_sampling = sum(ddim_res.timings[k] for k in ("stage1", "stage2_view0", "stage2"))
            log(
                f"phase fast modes: cli.main {' '.join(flags)} on the phase-11 PNG (SAM on, gate "
                f"loaded): " + cli_line(*run[:3], expected, *run[3:])
                + f" | int8 GEMM launches {gemms} | sampling spans {sampling:.4f} s = "
                f"{sampling / ddim_sampling:.3f} of the DDIM run's {ddim_sampling:.4f} s, call "
                f"{total / ddim_total:.3f} of its {ddim_total:.4f} s | {smi}"
            )
    finally:
        shutil.rmtree(PIPELINE_OUT, ignore_errors=True)

    # one full-width PLMS stage-1 call: views 0-3, 75 steps
    img = torch.as_tensor(input_image(), device="cuda") * 2.0 - 1.0
    flash_attention.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = stage.sample_views(img[None].expand(4, *img.shape), STAGE1_DELTA_X[:4],
                             STAGE1_DELTA_Y[:4], seed=1, steps=75, sampler="plms",
                             noise_ids=[0, 1, 2, 3])
    torch.cuda.synchronize()
    plms_s = time.perf_counter() - t0
    if flash_attention.launch_count != 16 * PLMS_STAGE1_EVALS:
        fail(f"plms stage1: {flash_attention.launch_count} K1 launches, expected "
             f"{16 * PLMS_STAGE1_EVALS}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        fail("plms stage1: images not finite in [0, 1]")
    log(f"phase fast modes: Zero123Stage.sample_views(sampler='plms', steps=75) of stage-1 "
        f"views 0-3 (B=8 with CFG): {plms_s:.4f} s, K1 launches {flash_attention.launch_count} "
        f"(expected {16 * PLMS_STAGE1_EVALS} = 16 x ({PLMS_STAGE1_EVALS - 1} entries + the "
        f"Heun eval)) | {smi}")

    # one quantized conv of each kind, card against CPU
    for name, k, stride, padding, cin, cout in INT8_CONVS:
        conv, cpu, card, x = quantized_conv_pair(name, k, stride, padding, cin, cout)
        xc = x.cuda()
        codes, xs = q.quantize_activation(xc)
        acc, _ = card.accumulate(xc)
        out = card(xc)
        torch.cuda.synchronize()
        ref_codes, ref_xs = q.quantize_activation(x)
        ref_acc, _ = cpu.accumulate(x)
        ref = cpu(x)
        if not torch.equal(codes.cpu(), ref_codes) or not torch.equal(xs.cpu(), ref_xs):
            fail(f"int8 conv {name}: activation codes or scale differ card vs CPU")
        if acc.dtype != torch.int32 or not torch.equal(acc.cpu(), ref_acc):
            fail(f"int8 conv {name}: int32 accumulations differ card vs CPU")
        err = float((out.float().cpu() - ref.float()).abs().max()) / float(ref.float().abs().max())
        if out.dtype != torch.bfloat16 or err > INT8_OUT_TOL:
            fail(f"int8 conv {name}: bf16 output {err} of max |ref| from the CPU's (> {INT8_OUT_TOL})")
        bf16 = conv.cuda().bfloat16()
        int8_ms, bf16_ms = time_ms(lambda: card(xc), 20), time_ms(lambda: bf16(xc), 20)  # noqa: B023
        log(f"phase fast modes: int8 conv {name} k={k} s={stride} C {cin}->{cout} at 8x32x32: "
            f"codes, scale and int32 accumulations [{', '.join(map(str, acc.shape))}] equal card "
            f"vs CPU bit for bit; bf16 output max abs {err:.3e} of max |ref| (<= {INT8_OUT_TOL:.3e});"
            f" QConv2d {int8_ms:.4f} ms vs bf16 cuDNN conv {bf16_ms:.4f} ms (events) | {smi}")

    # the full-width int8 UNet, B=2: card against CPU, and against the card's bf16 UNet
    state = q.quantize_unet_state(unet_weights)
    cpu_unet = int8_unet(state, "cpu", torch.float32)
    card_unet = int8_unet({k: v.cuda() for k, v in state.items()}, "cuda", torch.bfloat16)
    n = sum(isinstance(m, q.QConv2d) for m in card_unet.modules())
    if n != n_qconv:
        fail(f"int8 UNet: {n} QConv2d, the CLI run launched {n_qconv} int8 GEMMs per eval")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 32, 32, 8, generator=gen)
    t = torch.tensor([977, 421])
    ctx = torch.randn(2, 1, 768, generator=gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_unet(x, t, ctx)
    cpu_s = time.perf_counter() - t0
    del cpu_unet
    flash_attention.launch_count = q.int8_matmul.launch_count = 0
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: calls.append((mod, a[0].cpu())))
             for m in card_unet.modules() if isinstance(m, q.QConv2d)]
    try:
        with torch.inference_mode():
            out = card_unet(x.cuda(), t.cuda(), ctx.cuda())
            bf16_out = stage.unet(x.cuda(), t.cuda(), ctx.cuda())
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    launches = (flash_attention.launch_count, q.int8_matmul.launch_count)
    rel = float(torch.linalg.vector_norm(out.cpu() - ref) / torch.linalg.vector_norm(ref))
    qerr = float(torch.linalg.vector_norm(out - bf16_out) / torch.linalg.vector_norm(bf16_out))
    if not torch.isfinite(out).all() or rel > INT8_UNET_TOL:
        fail(f"int8 UNet card vs CPU: relative L2 {rel} (<= {INT8_UNET_TOL})")
    if launches != (32, n) or len(calls) != n:
        fail(f"int8 UNet + bf16 UNet: K1 / int8 GEMM launches {launches}, expected (32, {n}); "
             f"{len(calls)} int8 layer calls")
    # every int8 layer of the card's eval, replayed on the CPU from its input
    cpu_twin = {}
    for module, xin in calls:
        if module not in cpu_twin:
            twin = q.QConv2d(module.in_channels, module.out_channels, module.kernel_size,
                             module.stride, module.padding)
            twin.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
            twin.dtype = torch.bfloat16
            cpu_twin[module] = twin
        with torch.inference_mode():
            acc, _ = module.accumulate(xin.cuda())
            ref_acc, _ = cpu_twin[module].accumulate(xin)
            y, ref_y = module(xin.cuda()).float().cpu(), cpu_twin[module](xin).float()
        if not torch.equal(acc.cpu(), ref_acc):
            fail("int8 UNet: a layer's int32 accumulations differ card vs CPU on the card's input")
        if float((y - ref_y).abs().max()) > INT8_OUT_TOL * float(ref_y.abs().max()):
            fail(f"int8 UNet: a layer's bf16 output differs card vs CPU beyond {INT8_OUT_TOL}")
    log(f"phase fast modes: full-width int8 UNet B=2 ({n} int8 convs, conv-only): each of its "
        f"{len(calls)} int8 layer calls replayed on the CPU from the card's input, int32 "
        f"accumulations equal bit for bit, bf16 outputs within one rounding; the whole eval card "
        f"(bf16 compute) vs CPU (f32 compute) relative L2 {rel:.3e} (<= {INT8_UNET_TOL}); "
        f"quantization error, card int8 vs card bf16 UNet on the same weights: relative L2 "
        f"{qerr:.3e}; K1 launches 16 per eval; CPU eval {cpu_s:.1f} s | {smi}")

    # sampler and img2img update math, card f32 against CPU f32
    cpu_runs, card_runs = sampler_math("cpu"), sampler_math("cuda")
    lines = []
    for name, (ref, n_ref) in cpu_runs.items():
        got, n_got = card_runs[name]
        err = float(torch.linalg.vector_norm(got.cpu() - ref) / torch.linalg.vector_norm(ref))
        if not torch.isfinite(got).all() or err > SAMPLER_TOL or n_got != n_ref:
            fail(f"sampler math {name}: relative L2 {err} (<= {SAMPLER_TOL}), evals {n_got} / {n_ref}")
        lines.append(f"{name}: {n_got} evals, {err:.2e}")
    log(f"phase fast modes: sampler math at [8, 32, 32, 4], card f32 vs CPU f32 relative L2 "
        f"(<= {SAMPLER_TOL}): " + "; ".join(lines))

    # int8 and bf16 UNet evals, timed by CUDA events
    times = []
    for B in (8, 56):
        gen = torch.Generator(device="cuda").manual_seed(B)
        xb = torch.randn(B, 32, 32, 8, device="cuda", generator=gen)
        tb = torch.full((B,), 500, device="cuda")
        cb = torch.randn(B, 1, 768, device="cuda", generator=gen)
        for label, net in (("bf16", stage.unet), ("int8", card_unet)):
            with torch.inference_mode():
                times.append(f"B={B} {label} {time_ms(lambda: net(xb, tb, cb), 10, warmup=2):.2f}")  # noqa: B023
    log("phase fast modes: UNet eval ms (CUDA events, 10 evals after 2): " + ", ".join(times)
        + f" | {smi}")
    return card_unet, runs["--sampler dpmpp"]


def phase_fast_modes_profile(stage, card_unet, smi):
    """Profiled last: the kernels one card QConv2d call launches (the int8
    GEMM present, no conv kernel), and the int8 and bf16 UNet evals' device
    ms at B=8 and B=56 by kernel family, with the int8 GEMMs' and the
    quantize and dequantize passes' shares (kernels placed by QConv2d's
    profiler ranges)."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, k, stride, padding, cin, cout in INT8_CONVS:
        _, _, card, x = quantized_conv_pair(name, k, stride, padding, cin, cout)
        xc = x.cuda()
        card(xc)
        torch.cuda.synchronize()
        # the profiler can drop a call's records, all of them at times (an
        # H100 run once recorded no device event of this call): a run that
        # recorded no kernel or no int8_gemm range is made again, up to
        # three runs in all, and the check below reads the first complete one
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                card(xc)
                torch.cuda.synchronize()
            device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            gemm = [e for e in device if e.name == "int8_gemm"]
            if gemm and any(e.name not in INT8_RANGES for e in device):
                break
        else:
            fail(f"int8 conv {name}: three profiled calls recorded no int8_gemm range with kernels")
        kernels = [e.name for e in device if e.name not in INT8_RANGES]
        inside = [e.name for e in device if e.name not in INT8_RANGES and gemm
                  and gemm[0].time_range.start <= e.time_range.start < gemm[0].time_range.end]
        integer = [n for n in inside if any(t in n.lower() for t in ("s8", "i8", "imma", "int8"))]
        if not integer or any(("conv" in n.lower() or "cudnn" in n.lower()) for n in kernels):
            fail(f"int8 conv {name}: no integer GEMM in the int8_gemm range ({inside}), or a conv "
                 f"kernel ran: {kernels}")
        log(f"phase fast modes profile: int8 conv {name}: {len(kernels)} kernels, of which the "
            f"int8 GEMM: {inside}; no conv kernel")

    for B in (8, 56):
        gen = torch.Generator(device="cuda").manual_seed(B)
        xb = torch.randn(B, 32, 32, 8, device="cuda", generator=gen)
        tb = torch.full((B,), 500, device="cuda")
        cb = torch.randn(B, 1, 768, device="cuda", generator=gen)
        for label, net in (("bf16", stage.unet), ("int8", card_unet)):
            with torch.inference_mode():
                device_ms, _ = device_ms_per_call(lambda: net(xb, tb, cb), 3, INT8_RANGES)  # noqa: B023
                wall_ms, events, _ = profiled(lambda: net(xb, tb, cb))  # noqa: B023
            ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                            if e.name in INT8_RANGES)
            starts = [r[0] for r in ranges]
            families, shares = {}, dict.fromkeys(INT8_RANGES, 0.0)
            for e in events:
                if e.name in INT8_RANGES:
                    continue
                ms = (e.time_range.end - e.time_range.start) / 1e3
                families[kernel_family(e.name)] = families.get(kernel_family(e.name), 0.0) + ms
                i = bisect.bisect_right(starts, e.time_range.start) - 1
                if i >= 0 and e.time_range.start < ranges[i][1]:
                    shares[ranges[i][2]] += ms
            total = sum(families.values())
            busy = busy_ms([e for e in events if e.name not in INT8_RANGES])
            log(f"phase fast modes profile: UNet eval B={B} {label}: device {device_ms:.2f} ms per "
                f"eval (3 evals), profiled eval wall {wall_ms:.1f} ms, busy {busy / wall_ms:.3f} | "
                + (", ".join(f"{r} {v:.2f} ms ({v / total:.3f})" for r, v in shares.items())
                   + " | " if label == "int8" else "")
                + f"by family (ms): {by_family(families)} | {smi}")


def phase_sam_profile(stage, rgb, smi):
    """One warm bf16 SAM encode under torch.profiler: device ms by kernel
    family, the global blocks' share of the device time (kernels placed by
    the encoder's 'sam_block_global' / 'sam_block_window' ranges), busy
    share, peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("sam_block_global", "sam_block_window")
    stage._memo = None
    stage.set_image(rgb)  # warm
    stage._memo = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stage.set_image(rgb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak, base = torch.cuda.max_memory_allocated() / 2**30, base / 2**30
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [(e.name, e.time_range) for e in device if e.name in names]
    events = [e for e in device if e.name not in names]
    if not events:
        fail("profiler: no device events in the SAM encode")
    families, blocks, top = {}, {n: 0.0 for n in names + ("other",)}, {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        families[kernel_family(e.name)] = families.get(kernel_family(e.name), 0.0) + ms
        where = next((n for n, r in ranges if r.start <= e.time_range.start < r.end), "other")
        blocks[where] += ms
        top[e.name] = top.get(e.name, 0.0) + ms
    device_ms = sum(families.values())
    busy = busy_ms(events)
    log(
        f"phase sam profile: warm bf16 encode wall {wall_ms:.1f} ms, device {device_ms:.2f} ms in "
        f"{len(events)} device events, busy {busy:.1f} ms = {busy / wall_ms:.3f} of the wall | "
        f"4 global blocks {blocks['sam_block_global']:.2f} ms "
        f"({blocks['sam_block_global'] / device_ms:.3f} of the device time), 28 windowed blocks "
        f"{blocks['sam_block_window']:.2f} ms, outside the blocks {blocks['other']:.2f} ms | by "
        f"family (ms): {by_family(families)} | peak mem {peak:.2f} GiB ({peak - base:.2f} GiB "
        f"above the {base:.2f} GiB held before the encode) | {smi}"
    )
    log("phase sam profile: top kernels (device ms): " + "; ".join(
        f"{k[:100]} {v:.2f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]
    ))


def recon_params(seed: int, num_lods: int = 1) -> dict:
    """State dicts of a full-width ReconStage (with ``num_lods=2`` the lod1
    networks too; the lod0 ones are the same either way):
    ``seeded_state_dict`` weights for the feature, cost-volume and blending
    nets; each SDF MLP keeps the port's geometric init (a sphere, so the
    mesh is not empty) with its latent columns drawn N(0, 0.01^2), so that
    the volume moves the surface."""
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage

    base = ReconStage(ReconConfig(num_lods=num_lods), seed=seed, device="cpu")
    params = {
        key: seeded_state_dict(module, seed + i)
        for i, (key, module) in enumerate(base.modules().items())
    }
    gen = torch.Generator().manual_seed(seed)
    d_latent = ReconConfig().regnet_d_out
    for key in ("sdf", "sdf_lod1")[:num_lods]:
        for name, p in base.modules()[key].sdf_layer.state_dict().items():
            x = p.clone()
            if name.endswith(".v") and not name.startswith("lin0."):
                x[-d_latent:] = 0.01 * torch.randn(x[-d_latent:].shape, generator=gen)
            params[key][f"sdf_layer.{name}"] = x
    return params


def recon_run(stage, images, cams, resolution: int):
    """One timed reconstruct: (mesh, {span: seconds}, total seconds)."""
    import torch

    from one2345_tpu_torch.core.profiling import Timer

    timer = Timer(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = stage.reconstruct(images, cams, resolution=resolution, timer=timer)
    torch.cuda.synchronize()
    return mesh, timer.report(), time.perf_counter() - t0


def check_mesh(name: str, mesh):
    import numpy as np

    v, f, c = mesh["vertices"], mesh["faces"], mesh["colors"]
    if not np.isfinite(v).all() or len(f) <= 1000:
        fail(f"recon {name}: {len(f)} faces (need > 1000), finite vertices {np.isfinite(v).all()}")
    if f.min() < 0 or f.max() >= len(v):
        fail(f"recon {name}: face indices in [{f.min()}, {f.max()}] for {len(v)} vertices")
    if c.shape != v.shape or not np.isfinite(c).all() or c.min() < 0 or c.max() > 1:
        fail(f"recon {name}: colors {c.shape} not finite in [0, 1]")


def phase_recon(s2, smi):
    """The reconstruction stage at full width on the sampled views: returns
    (bf16 stage, images, cameras) for the profiled run of phase 11, and the
    stage's weights for the pipeline phase."""
    import numpy as np
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.geometry.cameras import build_recon_cameras
    from one2345_tpu_torch.native import build as native_build
    from one2345_tpu_torch.recon.pipeline import ReconStage

    t0 = time.perf_counter()
    native_build.build()
    gxx_s = time.perf_counter() - t0
    images = s2.reshape(-1, *s2.shape[-3:]).contiguous()  # [32, 256, 256, 3]
    cams = build_recon_cameras(POLAR_DEG)
    t0 = time.perf_counter()
    params = recon_params(seed=30)
    stage = ReconStage(ReconConfig(dtype="bfloat16"), params=params, device="cuda")
    log(
        f"phase recon: ReconStage(ReconConfig(dtype='bfloat16')) at full width, "
        f"{tuple(images.shape)} views, 96^3 volume, R={RECON_RESOLUTION}; built in "
        f"{time.perf_counter() - t0:.1f} s, marching tets library in {gxx_s:.1f} s"
    )
    meshes = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        mesh, spans, total = recon_run(stage, images, cams, RECON_RESOLUTION)
        check_mesh(run, mesh)
        meshes[run] = mesh
        log(
            f"phase recon ({run}): "
            + ", ".join(f"{k} {spans[k]:.4f} s" for k in RECON_SPANS)
            + f", total {total:.4f} s | {len(mesh['vertices'])} vertices, "
            f"{len(mesh['faces'])} faces | peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}"
        )
    cold, warm = meshes["cold"], meshes["warm"]
    if len(cold["faces"]) != len(warm["faces"]) or cold["vertices"].shape != warm["vertices"].shape:
        fail(f"recon warm {len(warm['faces'])} faces, cold {len(cold['faces'])}")
    rerun = float(np.abs(warm["vertices"] - cold["vertices"]).max())
    if rerun > 1e-5:
        fail(f"recon warm vertices differ from cold by {rerun} (> 1e-5)")

    # the f32 stage on the card against the same stage on the CPU
    f32 = {dev: ReconStage(ReconConfig(), params=params, device=dev) for dev in ("cuda", "cpu")}
    projs = torch.as_tensor(cams["affines"][1:33], dtype=torch.float32)
    vols, times = {}, {}
    for dev, st in f32.items():
        t0 = time.perf_counter()
        feats = st.feature_maps(images.to(st.device))
        vols[dev] = st.conditional_volume(feats, projs.to(st.device))
        u = st.field_grid(vols[dev]["volume"], RECON_CHECK_RESOLUTION)
        vols[dev]["field"] = u.cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        times[dev] = time.perf_counter() - t0
    card = {k: v.cpu() for k, v in vols["cuda"].items()}
    ref = vols["cpu"]
    rel = float(torch.linalg.vector_norm(card["volume"] - ref["volume"])
                / torch.linalg.vector_norm(ref["volume"]))
    mask_same = bool(torch.equal(card["mask"], ref["mask"]))
    field_err = float((card["field"] - ref["field"]).abs().max())
    valid = float(ref["mask"].mean())
    if not mask_same or not rel <= VOLUME_TOL or not field_err <= FIELD_TOL:
        fail(
            f"recon card f32 vs CPU f32: mask identical {mask_same}, volume relative L2 {rel} "
            f"(<= {VOLUME_TOL}), field max abs {field_err} (<= {FIELD_TOL})"
        )
    # the bf16 conv path against the f32 one, on the card
    out16 = stage.conditional_volume(stage.feature_maps(images), projs.to(stage.device))
    u16 = stage.field_grid(out16["volume"], RECON_CHECK_RESOLUTION).cpu()
    u32 = card["field"]
    # how far the conditional volume moves the f32 field off the bare
    # geometric-init sphere (a zero volume)
    sphere = f32["cuda"].field_grid(torch.zeros_like(vols["cuda"]["volume"]),
                                    RECON_CHECK_RESOLUTION).cpu()
    far = u32.abs() > 1e-2
    agree = float((torch.sign(u16[far]) == torch.sign(u32[far])).float().mean())
    if not agree >= SIGN_AGREEMENT:
        fail(f"recon bf16 field signs agree with f32 on {agree} of |u| > 1e-2 (>= {SIGN_AGREEMENT})")
    log(
        f"phase recon: card f32 vs CPU f32 at full width: mask identical, valid voxels "
        f"{valid:.4f}, volume relative L2 {rel:.3e} (<= {VOLUME_TOL}), field R="
        f"{RECON_CHECK_RESOLUTION} max abs {field_err:.3e} (<= {FIELD_TOL}), |u| max "
        f"{float(u32.abs().max()):.3f}, moved by the volume up to "
        f"{float((u32 - sphere).abs().max()):.3e}; bf16 vs f32 field sign agreement {agree:.6f} on "
        f"{float(far.float().mean()):.4f} of the lattice (>= {SIGN_AGREEMENT}), max abs "
        f"{float((u16 - u32).abs().max()):.3e}; warm vs cold vertices max abs {rerun:.3e}; "
        f"f32 card {times['cuda']:.2f} s, CPU {times['cpu']:.2f} s"
    )
    del f32, vols, card, ref
    return stage, images, cams, params


def kernel_family(name: str) -> str:
    """The family of a device kernel, by its name."""
    n = name.lower()
    for family, keys in (
        ("copies", ("memcpy", "memset", "copy_kernel", "catarray")),
        ("convs", ("conv", "cudnn", "fprop", "implicit", "winograd", "nchwtonhwc", "nhwctonchw")),
        ("matmuls", ("gemm", "gemv", "cutlass", "cublas", "nvjet")),
        ("gathers", ("index", "gather", "scatter", "grid_sampler")),
        ("resize", ("upsample", "interp")),
        ("reductions", ("reduce",)),
        ("elementwise", ("elementwise", "fill")),
    ):
        if any(k in n for k in keys):
            return family
    return "other"


def busy_ms(events) -> float:
    """Milliseconds in which at least one of the device ``events`` ran."""
    busy, end = 0.0, -math.inf
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def by_family(ms_by_family: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in sorted(ms_by_family.items(), key=lambda kv: -kv[1]))


def profiled(fn, span_names=()):
    """One call of ``fn`` under torch.profiler: (wall ms, the device events,
    {span: its time range}) where spans are ``Timer``'s record_function
    ranges on the device timeline, not counted as device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):  # the profiler can drop all of a call's device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ranges = {e.name: e.time_range for e in device if e.name in span_names}
        events = [e for e in device if e.name not in span_names]
        if events:
            return wall_ms, events, ranges
    fail("profiler: no device events in three profiled calls")


def phase_recon_profile(stage, images, cams, smi):
    """One warm reconstruct under torch.profiler: device ms by kernel
    family, in all and per span, the device's busy share of the wall time,
    host ms of marching tets.  The spans' own ranges on the device timeline
    (``Timer``'s record_function annotations) place each kernel in its
    span and are not counted as device work."""
    from one2345_tpu_torch.core.profiling import Timer

    timer = Timer(device="cuda")

    def call():
        timer.spans.clear()  # a profiled call made again starts its spans anew
        stage.reconstruct(images, cams, resolution=RECON_RESOLUTION, timer=timer)

    wall_ms, events, ranges = profiled(call, RECON_SPANS)
    busy = busy_ms(events)
    families: dict = {}
    per_span: dict = {}
    top: dict = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        fam = kernel_family(e.name)
        span = next((k for k, r in ranges.items() if r.start <= e.time_range.start < r.end), "none")
        families[fam] = families.get(fam, 0.0) + ms
        per_span.setdefault(span, {})
        per_span[span][fam] = per_span[span].get(fam, 0.0) + ms
        top[e.name] = top.get(e.name, 0.0) + ms
    device_ms = sum(families.values())
    spans = timer.report()
    log(
        f"phase recon profile: wall {wall_ms:.1f} ms, device {device_ms:.1f} ms in "
        f"{len(events)} device events, busy {busy:.1f} ms = {busy / wall_ms:.3f} of "
        f"the wall | by family (ms): {by_family(families)} | marching tets on the host "
        f"{spans['marching_tets'] * 1e3:.1f} ms | {smi}"
    )
    for span in (*RECON_SPANS, "none"):
        if span in spans or span in per_span:
            host = f"{spans[span] * 1e3:.1f} ms" if span in spans else "-"
            fams = per_span.get(span, {})
            log(
                f"phase recon profile: span {span}: wall {host}, device "
                f"{sum(fams.values()):.2f} ms ({by_family(fams) or 'no device work'})"
            )
    log("phase recon profile: top kernels (device ms): " + "; ".join(
        f"{k[:100]} {v:.2f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]
    ))


def phase_elevation_profile(est, views, smi):
    """One warm ElevationEstimator.estimate (bf16 matcher) under
    torch.profiler: device ms by kernel family, busy share, top kernels."""
    wall_ms, events, _ = profiled(lambda: est.estimate(views))
    families: dict = {}
    top: dict = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        fam = kernel_family(e.name)
        families[fam] = families.get(fam, 0.0) + ms
        top[e.name] = top.get(e.name, 0.0) + ms
    busy = busy_ms(events)
    log(
        f"phase elevation profile: estimate wall {wall_ms:.1f} ms, device "
        f"{sum(families.values()):.2f} ms in {len(events)} device events, busy {busy:.1f} ms = "
        f"{busy / wall_ms:.3f} of the wall | by family (ms): {by_family(families)} | {smi}"
    )
    log("phase elevation profile: top kernels (device ms): " + "; ".join(
        f"{k[:100]} {v:.2f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]
    ))


def train_batch(B: int):
    """A synthetic finetune batch on the card: target and conditioning
    images in [-1, 1] and the pose tokens of seeded camera pairs."""
    import numpy as np
    import torch

    from one2345_tpu_torch.training.data import relative_pose_token

    rng = np.random.default_rng(7)

    def camera():
        c2w = np.eye(4)
        d = rng.normal(size=3)
        c2w[:3, 3] = d / np.linalg.norm(d) * rng.uniform(1.5, 2.2)
        return c2w

    batch = {
        "image_target": np.stack([input_image(256, seed=20 + i) for i in range(B)]) * 2 - 1,
        "image_cond": np.stack([input_image(256, seed=40 + i) for i in range(B)]) * 2 - 1,
        "T": np.stack([relative_pose_token(camera(), camera()) for _ in range(B)])[:, None],
    }
    return {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in batch.items()}


def phase_train(stage, params, smi):
    """Six full-width finetune steps; returns the backward kernels' launches."""
    import torch

    from one2345_tpu_torch.core.profiling import unet_flops_per_eval
    from one2345_tpu_torch.ops.flash_attention import flash_attention as f
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    t0 = time.perf_counter()
    trainer = Zero123Trainer(
        stage, {k: params[k] for k in ("unet", "cc_projection")}, remat=True, device="cuda"
    )
    named = [
        (f"{m}.{k}", p) for m, module in trainer.modules.items()
        for k, p in module.named_parameters()
    ]
    start = [p.detach().clone() for _, p in named]
    n_params = sum(p.numel() for _, p in named)
    batch = train_batch(TRAIN_BATCH)
    log(
        f"phase train: Zero123Trainer at full width, {n_params / 1e6:.1f} M f32 trainable "
        f"parameters in {len(named)} tensors, remat, bf16 autocast, B={TRAIN_BATCH}, "
        f"built in {time.perf_counter() - t0:.1f} s"
    )
    # model FLOPs: UNet forward + backward (3x the forward); the remat
    # recompute, the frozen towers and the optimizer are not counted
    flops = 3 * unet_flops_per_eval(TRAIN_BATCH)
    totals = [0, 0, 0]
    warm = []
    for step in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        f.launch_count = f.dq_launch_count = f.dkv_launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (f.launch_count, f.dq_launch_count, f.dkv_launch_count)
        totals = [a + b for a, b in zip(totals, counts)]
        loss = float(loss)
        if counts != (32, 16, 16):
            fail(f"train step {step + 1}: fwd/dq/dkv launches {counts}, expected (32, 16, 16)")
        if not math.isfinite(loss):
            fail(f"train step {step + 1}: loss {loss}")
        extra = ""
        if step == 0:
            extra = " | " + check_first_step(trainer, named, start)
        else:
            warm.append(dt)
        log(
            f"phase train ({'cold' if step == 0 else 'warm'}) step {step + 1}: {dt:.4f} s, "
            f"loss {loss:.5f}, {TRAIN_BATCH / dt:.2f} samples/s, "
            f"UNet MFU {flops / dt / PEAK_BF16_FLOPS:.4f} ({flops / 1e12:.2f} TFLOP/step), "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"fwd/dq/dkv launches {counts}{extra}"
        )
    mean = sum(warm) / len(warm)
    log(
        f"phase train: {len(warm)} warm steps mean {mean:.4f} s (min {min(warm):.4f}, max "
        f"{max(warm):.4f}), {TRAIN_BATCH / mean:.2f} samples/s, UNet MFU "
        f"{flops / mean / PEAK_BF16_FLOPS:.4f} | {smi}"
    )
    return totals


def check_first_step(trainer, named, start) -> str:
    """After the first step: every read parameter has a finite, non-zero
    gradient, the unread ones an exact zero, and the params and EMA moved."""
    import torch

    dead, bad = 0, []
    for name, p in named:
        g = p.grad
        if name.endswith(DEAD):
            dead += 1
            if g is None or torch.count_nonzero(g) != 0:
                bad.append(name)
        elif g is None or not torch.isfinite(g).all() or not float(g.abs().max()) > 0:
            bad.append(name)
    if bad:
        fail(f"train step 1: gradient missing, zero or not finite for {bad[:8]} ({len(bad)})")
    attn1 = sum(".attn1.to_" in name for name, _ in named)
    ema = [t for d in trainer.ema.values() for t in d.values()]
    total = sum(p.numel() for _, p in named)
    moved = sum(int(torch.count_nonzero(p.detach() != s)) for (_, p), s in zip(named, start))
    ema_moved = sum(int(torch.count_nonzero(e != s)) for e, s in zip(ema, start))
    if not (moved > 0 and ema_moved > 0):
        fail(f"train step 1: params moved {moved}, EMA moved {ema_moved} of {total}")
    return (
        f"{len(named) - dead} gradients finite and non-zero (of them {attn1} attn1 "
        f"projection tensors), {dead} unread parameters with zero gradient; params moved "
        f"{moved / total:.4f}, EMA {ema_moved / total:.4f} of {total} elements"
    )


def rel_l2_np(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def recon_train_check(params, scene) -> str:
    """(a) One ReconTrainer.scene_loss with its backward on the card (f32),
    on the CPU (f32) and on the CPU in float64 (the reference), TF32 off:
    the same seeded weights (lod1 networks included), the same scene cut
    to RECON_TRAIN_CHECK, the same injected draws; at lod0 (num_lods=1)
    and lod1 (num_lods=2).  The lod1 branch of every run takes the CPU f32
    run's pruned occupancy: a voxel within f32 error of the threshold can
    flip between devices, and the lod1 batch norms spread a flip to every
    voxel (the pruning is compared on its own in (c)); the flips of the
    card's own pruning are counted."""
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    views = RECON_TRAIN_VIEWS
    n_rays = RECON_TRAIN_CHECK["n_rays"]
    cut = {k: (v[views] if k in ("images", "affines", "w2cs", "intrinsics") else v[:n_rays]
               if k.startswith("rays_") else v) for k, v in scene.items()}
    lines = []
    for num_lods in (1, 2):
        cfg = ReconConfig(num_lods=num_lods, **RECON_TRAIN_CHECK)
        gen = torch.Generator().manual_seed(40 + num_lods)
        draws = {}
        for sfx in ("", "_lod1")[:num_lods]:
            draws["t_rand" + sfx] = torch.rand((n_rays, cfg.n_samples), generator=gen)
            draws["pts_random" + sfx] = torch.rand((1024, 3), generator=gen) * 2.0 - 1.0
        res, masks, vols = {}, {}, {}
        for run, dev, dtype in (("cpu", "cpu", torch.float32), ("card", "cuda", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
            stage = ReconStage(cfg, params=params, device=dev)
            for m in stage.modules().values():
                m.to(dtype)

            def shared_prune(volume, mask, own=stage.prune_occupancy, run=run):
                masks[run] = own(volume, mask).cpu()
                return masks["cpu"].to(volume.device)

            def kept_volume(*args, own=stage.sdf_net_lod1.build_volume if num_lods > 1 else None,
                            run=run):
                out = own(*args)
                vols[run] = {k: v.detach().cpu().double() for k, v in out.items()}
                return out

            stage.prune_occupancy = shared_prune
            if num_lods > 1:
                stage.sdf_net_lod1.build_volume = kept_volume
            tr = ReconTrainer(stage, cfg)
            tr.dtype = dtype
            t0 = time.perf_counter()
            loss, metrics = tr.scene_loss(cut, RECON_TRAIN_STEP, draws)
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            grads = {f"{k}.{n}": p.grad.detach().cpu().double() for k, m in tr.modules.items()
                     for n, p in m.named_parameters()}
            stats = {f"{k}.{n}": t.detach().cpu().double() for k, m in tr.modules.items()
                     for n, t in m.state_dict().items() if "running" in n}
            res[run] = ({k: float(v) for k, v in metrics.items()}, grads, stats, dt)
        (m_gpu, g_gpu, s_gpu, dt_gpu), (m_cpu, g_cpu, s_cpu, dt_cpu) = res["card"], res["cpu"]
        g64, dt64 = res["cpu64"][1], res["cpu64"][3]
        m64 = res["cpu64"][0]

        def metric_errs(m):
            return {k: abs(m[k] - v) / max(abs(v), 1e-30) for k, v in m64.items()}

        me_card, me_cpu = metric_errs(m_gpu), metric_errs(m_cpu)
        cpu_worst = max(me_cpu.values())
        problems = [
            f"metric {k}: card {m_gpu[k]}, CPU {m_cpu[k]}, CPU f64 {v}"
            for k, v in m64.items()
            if not (math.isfinite(m_gpu[k]) and me_card[k] <= max(
                RECON_SPARSE_TOL if k.startswith("sparse") else RECON_LOSS_TOL,
                RECON_GRAD_FACTOR * cpu_worst))
        ]
        norm64 = math.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
        floor = 1e-6 * norm64

        def errs(g):
            per = {k: float((g[k] - r).norm()) / max(float(r.norm()), floor)
                   for k, r in g64.items() if k not in ZERO_GRADS}
            total = math.sqrt(sum(float(((g[k] - r) ** 2).sum()) for k, r in g64.items()))
            return per, total / norm64

        e_card, glob_card = errs(g_gpu)
        e_cpu, glob_cpu = errs(g_cpu)
        vs_cpu = {k: float((g_gpu[k] - g).norm()) / max(float(g.norm()), floor)
                  for k, g in g_cpu.items() if k not in ZERO_GRADS}
        bound = max(RECON_GRAD_TOL, RECON_GRAD_FACTOR * max(e_cpu.values()))
        zeros = max(max(float(g_gpu[k].norm()), float(g64[k].norm())) for k in ZERO_GRADS
                    if k in g64)
        worst = max(e_card, key=e_card.get)
        stat_err = max(float((s_gpu[k] - v).abs().max()) for k, v in s_cpu.items())
        if (not e_card[worst] <= bound
                or not glob_card <= max(RECON_GRAD_TOL, RECON_GRAD_FACTOR * glob_cpu)
                or not zeros <= floor or not stat_err <= RECON_STATS_TOL):
            problems.append(
                f"card f32 vs CPU f64 worst gradient {worst} {e_card[worst]} (<= {bound}), "
                f"global {glob_card} (CPU f32 {glob_cpu}), zero-gradient biases {zeros} (floor "
                f"{floor}), running stats {stat_err}")
        flips = ""
        if masks:
            flips = (f", the card's own pruning flips {int((masks['card'] != masks['cpu']).sum())} "
                     f"of {masks['cpu'].numel()} voxels; lod1 volume card vs CPU: masks differ at "
                     f"{int((vols['card']['mask'] != vols['cpu']['mask']).sum())} voxels, "
                     f"volume relative L2 {rel_l2_np(vols['card']['volume'], vols['cpu']['volume']):.2e}"
                     f" (CPU f32 vs f64 {rel_l2_np(vols['cpu']['volume'], vols['cpu64']['volume']):.2e})")
        if problems:
            fail(f"recon train (a) lod{num_lods - 1}{flips}: " + "; ".join(problems))
        if num_lods == 2:  # the float64 reference of the bf16 phase's check
            RECON_REF.update(cfg=cfg, cut=cut, draws=draws, mask=masks["cpu"], m64=m64,
                             g64=g64, card_metrics=me_card, card_grads=e_card,
                             card_global=glob_card)
        lines.append(
            f"lod{num_lods - 1} (num_lods={num_lods}){flips}: loss {m64['loss']:.6f}; metrics "
            f"against CPU f64: card f32 worst {max(me_card.values()):.2e} "
            f"({max(me_card, key=me_card.get)}), CPU f32 worst {cpu_worst:.2e}; "
            f"{len(e_card)} gradients against CPU f64: card f32 worst "
            f"{e_card[worst]:.2e} ({worst}), global {glob_card:.2e}; CPU f32 worst "
            f"{max(e_cpu.values()):.2e}, global {glob_cpu:.2e} (bound {bound:.2e}); card vs CPU "
            f"f32 worst {max(vs_cpu.values()):.2e}; zero-gradient biases {zeros:.1e} (floor "
            f"{floor:.1e}); {len(s_cpu)} running stats card vs CPU max abs {stat_err:.2e}; card "
            f"{dt_gpu:.2f} s, CPU {dt_cpu:.2f} s, CPU f64 {dt64:.2f} s"
        )
    return "; ".join(lines)


def read_metrics(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def recon_train_run(params, smi):
    """(b) train_recon.main at full width on phase 9's scene: 4 lod1 steps
    with validation at step 2 and checkpoints at 2 and 4, metrics and PNGs
    read back, the checkpoint reloaded, --resume for a fifth step, one
    lod0 step.  Returns the trainer."""
    import numpy as np
    import torch

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.training import train_recon
    from one2345_tpu_torch.utils.png import read_png

    data = os.path.join(SCENES_OUT, "data")
    init = os.path.join(SCENES_OUT, "init.pt")
    checkpoint.save(init, params)
    exp = os.path.join(SCENES_OUT, "exp")
    args = ["--data_root", data, "--init_params", init, "--log_every", "1", "--exp_dir", exp]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_recon.main(args + ["--num_lods", "2", "--max_steps", "4", "--val_every", "2",
                                       "--ckpt_every", "2"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = read_metrics(os.path.join(exp, "metrics.jsonl"))
    steps = [r for r in recs if "loss" in r]
    vals = [r for r in recs if "loss" not in r]
    if [r["step"] for r in steps] != [0, 1, 2, 3] or not all(
            math.isfinite(v) for r in recs for v in r.values()):
        fail(f"recon train (b): metrics records {recs}")
    if sorted(k for r in vals for k in r if k.startswith("val_")) != ["val_psnr", "val_psnr_lod1"] \
            or any(r["step"] != 2 for r in vals):
        fail(f"recon train (b): validation records {vals}")
    for key in ("psnr", "psnr_lod1", "eikonal", "eikonal_lod1", "color_loss_lod1"):
        if key not in steps[0]:
            fail(f"recon train (b): no {key} in the metrics")
    panels = []
    for sfx in ("", "_lod1"):
        png = read_png(os.path.join(exp, "val", f"step_000002{sfx}.png"))
        if png.shape != (256, 1024, 3) or png.std() == 0:
            fail(f"recon train (b): validation panel{sfx} {png.shape}, std {png.std()}")
        panels.append(png)
    names = sorted(os.listdir(exp))
    if names != ["metrics.jsonl", "step_000002", "step_000004", "val"]:
        fail(f"recon train (b): {names} in the run's directory")
    state = checkpoint.restore(os.path.join(exp, "step_000004"))
    same = all(torch.equal(state["params"][k][n], t.cpu()) for k, m in trainer.modules.items()
               for n, t in m.state_dict().items())
    if state["step"] != 4 or not same or len(state["params"]) != 8:
        fail(f"recon train (b): checkpoint step {state['step']}, params equal {same}")
    secs = [1.0 / r["steps_per_sec"] for r in steps]
    RECON_F32.update(secs=secs, peak=peak)
    val = {k: v for r in vals for k, v in r.items() if k.startswith("val_")}
    log(
        f"phase recon train (b): train_recon.main --num_lods 2 --max_steps 4 --val_every 2 "
        f"--ckpt_every 2 at full width (ReconConfig(num_lods=2): 33 views at 256^2, 96^3 then "
        f"192^3, {trainer.cfg.n_rays} rays of {trainer.cfg.n_samples} + {trainer.cfg.n_importance} "
        f"samples, f32, TF32 off): {total:.2f} s in all, seconds per step "
        + ", ".join(f"{s:.3f}" for s in secs)
        + f" (step 0 cold, step 2 with the lod0 and lod1 validation renders), loss "
        + ", ".join(f"{r['loss']:.4f}" for r in steps)
        + f", psnr_lod1 {steps[-1]['psnr_lod1']:.2f}, val psnr {val['val_psnr']:.2f} / lod1 "
        f"{val['val_psnr_lod1']:.2f} | peak mem {peak:.2f} GiB | {smi}"
    )
    t0 = time.perf_counter()
    resumed = train_recon.main(args + ["--num_lods", "2", "--max_steps", "5", "--resume",
                                       "--ckpt_every", "100"])
    resume_s = time.perf_counter() - t0
    recs = read_metrics(os.path.join(exp, "metrics.jsonl"))
    if resumed.step != 5 or [r["step"] for r in recs if "loss" in r] != [0, 1, 2, 3, 4]:
        fail(f"recon train (b): --resume ran to step {resumed.step}, records {recs[-2:]}")
    exp0 = os.path.join(SCENES_OUT, "exp_lod0")
    t0 = time.perf_counter()
    one = train_recon.main(["--data_root", data, "--init_params", init, "--exp_dir", exp0,
                            "--num_lods", "1", "--max_steps", "1"])
    lod0_s = time.perf_counter() - t0
    rec = read_metrics(os.path.join(exp0, "metrics.jsonl"))
    if one.step != 1 or len(one.modules) != 4 or len(rec) != 1 or "loss_lod1" in rec[0] \
            or not all(math.isfinite(v) for v in rec[0].values()):
        fail(f"recon train (b): the --num_lods 1 run: step {one.step}, records {rec}")
    log(
        f"phase recon train (b): validation panels step_000002.png and _lod1.png read back "
        f"(256x1024x3), checkpoint step_000004 reloaded equal to the trainer (8 networks, step "
        f"4); --resume --max_steps 5 continued at step 4 ({resume_s:.2f} s, loss "
        f"{recs[-1]['loss']:.4f}); --num_lods 1 --max_steps 1: {lod0_s:.2f} s, loss "
        f"{rec[0]['loss']:.4f}"
    )
    del resumed, one
    return trainer


def recon_lod1(trained, scene_images, cams, smi):
    """(c) ReconStage(ReconConfig(num_lods=2)) at full width on the trained
    weights, cold and warm: spans, mesh checks; the pruned occupancy card
    against CPU; the depth-filtered pruning once, its depth maps card
    against CPU."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage

    cfg = ReconConfig(num_lods=2)
    stage = ReconStage(cfg, params=trained, device="cuda")
    images = torch.as_tensor(scene_images, device="cuda")
    meshes = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        mesh, spans, total = recon_run(stage, images, cams, RECON_RESOLUTION)
        if tuple(spans) != RECON_LOD1_SPANS:
            fail(f"recon lod1 {run}: spans {tuple(spans)}")
        check_mesh(f"lod1 {run}", mesh)
        meshes[run] = mesh
        log(
            f"phase recon train (c) lod1 reconstruct ({run}): "
            + ", ".join(f"{k} {spans[k]:.4f} s" for k in RECON_LOD1_SPANS)
            + f", total {total:.4f} s | {len(mesh['vertices'])} vertices, {len(mesh['faces'])} "
            f"faces | peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}"
        )
    cold, warm = meshes["cold"], meshes["warm"]
    if cold["vertices"].shape != warm["vertices"].shape or \
            float(np.abs(warm["vertices"] - cold["vertices"]).max()) > 1e-5:
        fail("recon lod1: warm mesh differs from cold")

    # the pruned occupancy, card against CPU, on the card's lod0 volume
    def cam(key, sel=slice(1, 33)):
        return torch.as_tensor(np.asarray(cams[key][sel]), dtype=torch.float32)

    cpu = ReconStage(cfg, params=trained, device="cpu")
    out = stage.conditional_volume(stage.feature_maps(images), cam("affines").cuda())
    vol, mask = out["volume"], out["mask"]
    t0 = time.perf_counter()
    occ_card = stage.prune_occupancy(vol, mask)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    occ_card = occ_card.cpu()[..., 0]
    occ_cpu = cpu.prune_occupancy(vol.cpu(), mask.cpu())[..., 0]
    u = cpu.field_grid(vol.cpu(), cfg.vol_dims[0])
    # the pruning compares the f16-rounded field with the threshold: in f32
    # its boundary is the midpoint of the f16 values around the threshold
    thr16 = np.float16(cfg.lod1_prune_threshold)
    lo16 = thr16 if float(thr16) < cfg.lod1_prune_threshold else np.nextafter(thr16, np.float16(0))
    hi16 = np.nextafter(lo16, np.float16(1))
    boundary = 0.5 * (float(lo16) + float(hi16))
    near = ((u.abs() - boundary).abs() <= 1e-6).float()
    near = F.max_pool3d(near[None, None], 7, stride=1, padding=3)[0, 0] > 0
    diff = occ_card != occ_cpu
    if bool((diff & ~near).any()):
        fail(f"recon lod1: pruned occupancy card vs CPU differs at {int((diff & ~near).sum())} "
             f"voxels away from the threshold")
    # the depth-filtered pruning, once; its depth maps card against CPU
    args = (cam("affines"), cam("intrinsics"), cam("c2ws"),
            torch.as_tensor(cams["near_fars"][1], dtype=torch.float32), tuple(cfg.image_hw))
    t0 = time.perf_counter()
    occ_df = stage.prune_occupancy_depth_filter(vol, mask, *(a.cuda() if torch.is_tensor(a) else a
                                                             for a in args))
    torch.cuda.synchronize()
    df_s = time.perf_counter() - t0
    d_card = stage.lod0_depth_maps(stage._pruning_field(vol), *(a.cuda() for a in args[1:4]),
                                   args[4]).cpu()
    d_cpu = cpu.lod0_depth_maps(cpu._pruning_field(vol.cpu()), *args[1:])
    hit_card, hit_cpu = d_card > 0, d_cpu > 0
    agree = float((hit_card == hit_cpu).float().mean())
    both = hit_card & hit_cpu
    err = (d_card - d_cpu).abs()[both]
    close = float((err <= 1e-4).float().mean()) if err.numel() else 1.0
    bracket = 2 * 2.0 / cfg.vol_dims[0]
    if not agree >= 0.99 or not close >= 0.9 or float(err.max()) > bracket:
        fail(f"recon lod1: depth maps card vs CPU: hits agree {agree}, common hits within 1e-4 "
             f"{close}, max {float(err.max())} (<= {bracket})")
    log(
        f"phase recon train (c): pruned occupancy (|u| < {cfg.lod1_prune_threshold}, 7^3 "
        f"dilation, the lod0 mask) on the card in {prune_s:.3f} s keeps "
        f"{float(occ_card.float().mean()):.4f} of 96^3; card vs CPU {int(diff.sum())} voxels "
        f"differ, all within the dilation of {int(((u.abs() - boundary).abs() <= 1e-6).sum())} "
        f"voxels within 1e-6 of the f16 field's boundary {boundary:.7f}; depth-filtered pruning "
        f"on the card {df_s:.3f} s keeps {float(occ_df.float().mean()):.4f}; its 32 depth maps "
        f"at 64^2 card vs CPU: hits agree on {agree:.5f} of the pixels "
        f"({float(hit_cpu.float().mean()):.4f} hit), {close:.5f} of the common hits within "
        f"1e-4, max {float(err.max()):.2e} (<= the secant bracket {bracket:.4f})"
    )


def phase_recon_train(smi):
    """Phase 14: reconstruction training on phase 9's scene, (a) card
    against CPU, (b) train_recon.main at full width, (c) the lod1
    reconstruct on the trained weights.  Returns (trainer, a full scene)
    for the profile of phase 20; the scene stays for phase 15."""
    import torch

    from one2345_tpu_torch.training.data import ReconScenesDataset

    t_phase = time.perf_counter()
    data = os.path.join(SCENES_OUT, "data")
    if not os.path.isfile(os.path.join(data, "shape0", "pose.json")):
        fail(f"recon train: no scene under {data} (phase 9 keeps one)")
    params = recon_params(seed=30, num_lods=2)
    ds = ReconScenesDataset(data, n_rays=512)
    scene = ds.sample_scene(0, generator=torch.Generator().manual_seed(3))
    loaded = ds.load_scene(0)
    log(
        f"phase recon train: phase 9's scene ({len(scene['images'])} views at 256^2, "
        f"{int(scene['rays_mask'].sum())} of 512 rays on the foreground), seeded weights of "
        f"the 8 networks"
    )
    log("phase recon train (a): card f32 vs CPU f32 and f64, TF32 off, 9 views, 48^3 / "
        "96^3, 64 rays, full widths: " + recon_train_check(params, scene))
    trainer = recon_train_run(params, smi)
    recon_lod1(trainer.state_dict()["params"], loaded["images"][1:], loaded["cameras"], smi)
    log(f"phase recon train: {time.perf_counter() - t_phase:.1f} s in all")
    return trainer, scene


def phase_recon_train_profile(trainer, scene, smi):
    """One warm full-width lod1 train step under torch.profiler: device ms
    by kernel family, in all and in its forward, backward and optimizer
    ranges, the backward's share, the busy share."""
    import torch

    def step():
        trainer.optimizer.zero_grad(set_to_none=True)
        with torch.profiler.record_function("train_forward"):
            loss, _ = trainer.scene_loss(scene)
        with torch.profiler.record_function("train_backward"):
            loss.backward()
        with torch.profiler.record_function("train_optimizer"):
            trainer.optimizer_step()

    wall_ms, events, ranges = profiled(step, TRAIN_PHASES)
    # autograd launches the backward from its own thread, outside the
    # main thread's range: the backward is what runs between the
    # forward's end and the optimizer's start on the device timeline
    fwd_end = ranges["train_forward"].end
    opt_start = ranges["train_optimizer"].start

    def phase(e):
        t = e.time_range.start
        return "train_forward" if t < fwd_end else "train_backward" if t < opt_start else \
            "train_optimizer"

    families, per_range = {}, {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        fam = kernel_family(e.name)
        families[fam] = families.get(fam, 0.0) + ms
        per_range.setdefault(phase(e), {})
        per_range[phase(e)][fam] = per_range[phase(e)].get(fam, 0.0) + ms
    device_ms = sum(families.values())
    busy = busy_ms(events)
    bwd = sum(per_range.get("train_backward", {}).values())
    top: dict = {}
    for e in events:
        top[e.name] = top.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    log(
        f"phase recon train profile: one warm lod1 step, wall {wall_ms:.1f} ms, device "
        f"{device_ms:.1f} ms in {len(events)} device events, busy {busy:.1f} ms = "
        f"{busy / wall_ms:.3f} of the wall, backward {bwd:.1f} ms = {bwd / device_ms:.3f} of the "
        f"device time | by family (ms): {by_family(families)} | {smi}"
    )
    for rng in TRAIN_PHASES:
        fams = per_range.get(rng, {})
        log(f"phase recon train profile: {rng}: device {sum(fams.values()):.2f} ms "
            f"({by_family(fams) or 'no device work'})")
    log("phase recon train profile: top kernels (device ms): " + "; ".join(
        f"{k[:90]} {v:.1f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:10]
    ))


# ------------------------------------------------------------------ finetune
def finetune_grads(trainer) -> dict:
    """The trained tensors' gradients, float64 on the host."""
    out = {"volume": trainer.volume.grad}
    out.update({f"sdf_layer.{k}": p.grad for k, p in trainer.sdf_layer.named_parameters()})
    out.update({f"blend.{k}": p.grad for k, p in trainer.blend_net.named_parameters()})
    return {k: v.detach().cpu().double() for k, v in out.items()}


def finetune_check(params, images, cams) -> str:
    """One FinetuneTrainer step's loss, metrics and gradients on the card
    (f32), on the CPU (f32) and on the CPU in float64 (the reference), TF32
    off, at full widths cut to FT_CHECK: the same conditional volume (built
    once on the CPU), the same rays, the same blending net."""
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.geometry.rays import random_rays_from_image
    from one2345_tpu_torch.recon.finetune import FinetuneTrainer
    from one2345_tpu_torch.recon.pipeline import ReconStage

    cfg = ReconConfig(vol_dims=FT_CHECK["vol_dims"], voxel_size=FT_CHECK["voxel_size"])
    src = FT_CHECK["views"]
    imgs = torch.as_tensor(images[src], dtype=torch.float32)
    cpu = ReconStage(cfg, params=params, device="cpu")
    out = cpu.conditional_volume(cpu.feature_maps(imgs), torch.as_tensor(cams["affines"][src]))
    volume, mask = out["volume"], out["mask"]
    img0 = torch.as_tensor(images[0], dtype=torch.float32)
    fg = (~(img0 > 245 / 255.0).all(dim=-1)).float()
    rays = random_rays_from_image(torch.Generator().manual_seed(5), FT_CHECK["n_rays"], img0,
                                  torch.as_tensor(cams["intrinsics"][0]),
                                  torch.as_tensor(cams["c2ws"][0]), mask=fg)
    scene = {"rays_o": rays["rays_o"], "rays_v": rays["rays_v"],
             "rays_color": rays["rays_color"], "near_far": cams["near_fars"][0],
             "images": imgs, "w2cs": cams["w2cs"][src], "intrinsics": cams["intrinsics"][src]}
    res, blend = {}, None
    for run, dev, dtype in (("cpu", "cpu", torch.float32), ("card", "cuda", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        stage = ReconStage(cfg, params=params, device=dev)
        for m in stage.modules().values():
            m.to(dtype)
        tr = FinetuneTrainer(stage, lr=FT_LR, dtype=dtype)
        tr.init_state(volume, mask, blend)
        if blend is None:
            blend = {k: v.clone() for k, v in tr.blend_net.state_dict().items()}
        t0 = time.perf_counter()
        loss, metrics = tr.loss_fn(mask, scene)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        res[run] = ({k: float(v.detach()) for k, v in metrics.items()}, finetune_grads(tr),
                    time.perf_counter() - t0)
    (m_card, g_card, dt_card), (m_cpu, g_cpu, dt_cpu) = res["card"], res["cpu"]
    m64, g64, dt64 = res["cpu64"]

    def metric_errs(m):
        return {k: abs(m[k] - v) / max(abs(v), 1e-30) for k, v in m64.items()}

    me_card, me_cpu = metric_errs(m_card), metric_errs(m_cpu)
    m_bound = max(FT_LOSS_TOL, FT_FACTOR * max(me_cpu.values()))
    norm64 = math.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
    floor = 1e-6 * norm64

    def errs(g):
        per = {k: float((g[k] - r).norm()) / max(float(r.norm()), floor) for k, r in g64.items()}
        glob = math.sqrt(sum(float(((g[k] - r) ** 2).sum()) for k, r in g64.items())) / norm64
        return per, glob

    e_card, glob_card = errs(g_card)
    e_cpu, glob_cpu = errs(g_cpu)
    g_bound = max(FT_GRAD_TOL, FT_FACTOR * max(e_cpu.values()))
    worst = max(e_card, key=e_card.get)
    if (not all(math.isfinite(v) for v in m_card.values()) or max(me_card.values()) > m_bound
            or e_card[worst] > g_bound
            or glob_card > max(FT_GRAD_TOL, FT_FACTOR * glob_cpu)):
        fail(f"finetune card vs CPU f64: metrics card {m_card}, CPU f64 {m64} (bound {m_bound}); "
             f"worst gradient {worst} {e_card[worst]} (bound {g_bound}), global {glob_card} "
             f"(CPU f32 {glob_cpu})")
    return (
        f"loss {m64['loss']:.6f}; metrics against CPU f64: card f32 worst "
        f"{max(me_card.values()):.2e} ({max(me_card, key=me_card.get)}), CPU f32 worst "
        f"{max(me_cpu.values()):.2e} (bound {m_bound:.2e}); {len(e_card)} gradients against CPU "
        f"f64: card f32 worst {e_card[worst]:.2e} ({worst}), global {glob_card:.2e}; CPU f32 "
        f"worst {max(e_cpu.values()):.2e}, global {glob_cpu:.2e} (bound {g_bound:.2e}); card "
        f"{dt_card:.2f} s, CPU {dt_cpu:.2f} s, CPU f64 {dt64:.2f} s"
    )


def phase_finetune(recon_p, smi):
    """Phase 15: FinetuneTrainer at ReconConfig() on phase 14's scene with
    phase 8's lod0 weights: FT_STEPS steps of FT_RAYS rays, the views in turn
    (examples/recon_quality.py:309-317), the stage untouched, the R=256 mesh
    of the finetuned volume and SDF MLP coloured by the finetuned blending
    net (:327-395); then the card-against-CPU step of ``finetune_check``."""
    import numpy as np
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.geometry.rays import random_rays_from_image
    from one2345_tpu_torch.recon import mesh_extract
    from one2345_tpu_torch.recon.finetune import FinetuneTrainer, pixel_warp
    from one2345_tpu_torch.recon.pipeline import VERT_CHUNK, ReconStage
    from one2345_tpu_torch.training.data import ReconScenesDataset

    data = os.path.join(SCENES_OUT, "data")
    if not os.path.isfile(os.path.join(data, "shape0", "pose.json")):
        fail(f"finetune: no scene under {data} (phase 9 keeps one)")
    sc = ReconScenesDataset(data).load_scene(0)
    images, cams = sc["images"], sc["cameras"]
    cfg = ReconConfig()
    stage = ReconStage(cfg, params=recon_p, device="cuda")

    def cam(key, sel=slice(1, 33)):
        return torch.as_tensor(np.asarray(cams[key][sel]), dtype=torch.float32, device="cuda")

    imgs = torch.as_tensor(images, dtype=torch.float32, device="cuda")
    src = imgs[1:]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = stage.conditional_volume(stage.feature_maps(src), cam("affines"))
    volume, mask = out["volume"], out["mask"]
    field_before = stage.field_grid(volume, RECON_CHECK_RESOLUTION).cpu()
    sdf_before = {k: v.clone() for k, v in stage.sdf_net.sdf_layer.state_dict().items()}
    trainer = FinetuneTrainer(stage, lr=FT_LR, seed=3)
    trainer.init_state(volume, mask)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fg = (~(imgs > 245 / 255.0).all(dim=-1)).float()
    Ks, c2ws, nfs = cam("intrinsics", slice(None)), cam("c2ws", slice(None)), cam("near_fars",
                                                                                  slice(None))
    gen = torch.Generator(device="cuda").manual_seed(11)
    base = {"images": src, "w2cs": cam("w2cs"), "intrinsics": cam("intrinsics")}
    secs, recs = [], []
    for i in range(FT_STEPS):
        v = i % len(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rays = random_rays_from_image(gen, FT_RAYS, imgs[v], Ks[v], c2ws[v], mask=fg[v])
        scene = {**base, "rays_o": rays["rays_o"], "rays_v": rays["rays_v"],
                 "rays_color": rays["rays_color"], "near_far": nfs[v]}
        m = trainer.train_step(mask, scene)
        m = {k: float(x) for k, x in m.items()}
        secs.append(time.perf_counter() - t0)
        if not all(math.isfinite(x) for x in m.values()):
            fail(f"finetune step {i}: metrics {m}")
        recs.append(m)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same_field = torch.equal(stage.field_grid(volume, RECON_CHECK_RESOLUTION).cpu(), field_before)
    same_sdf = all(torch.equal(v, sdf_before[k])
                   for k, v in stage.sdf_net.sdf_layer.state_dict().items())
    if trainer.step != FT_STEPS or not same_field or not same_sdf:
        fail(f"finetune: step {trainer.step}, the stage's field unchanged {same_field}, its SDF "
             f"MLP unchanged {same_sdf}")
    warm = secs[1:]
    log(
        f"phase finetune: FinetuneTrainer(lr={FT_LR}) at ReconConfig() (32 source views at "
        f"256^2, 96^3 x 16 volume, SDF MLP {cfg.hidden_dim}, {cfg.n_samples} + "
        f"{cfg.n_importance} samples), {FT_STEPS} steps of {FT_RAYS} rays cycling the 33 views: "
        f"setup (features + volume) {setup_s:.3f} s, step 1 (cold) {secs[0]:.4f} s, warm mean "
        f"{sum(warm) / len(warm):.4f} s (min {min(warm):.4f}, max {max(warm):.4f}); loss "
        f"{recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f}, color {recs[0]['color']:.4f} -> "
        f"{recs[-1]['color']:.4f}, every metric finite; the stage's 64^3 field and SDF MLP "
        f"unchanged | peak mem {peak:.2f} GiB | {smi}"
    )

    # the mesh of the finetuned field, coloured by the finetuned blending net
    t0 = time.perf_counter()
    params_ft = dict(recon_p)
    params_ft["sdf"] = {**recon_p["sdf"], **{f"sdf_layer.{k}": v.detach().cpu() for k, v in
                                             trainer.sdf_layer.state_dict().items()}}
    stage_ft = ReconStage(cfg, params=params_ft, device="cuda")
    vol_ft = (trainer.volume * mask).detach()
    R = RECON_RESOLUTION
    u = stage_ft.gate_field(stage_ft.field_grid(vol_ft, R), mask).cpu().numpy()
    verts_grid, faces = mesh_extract.marching_tetrahedra(u, cfg.mesh_threshold)
    verts_n = mesh_extract.grid_to_world(verts_grid, (-1, -1, -1), (1, 1, 1), R)
    colors = []
    with torch.no_grad():
        pts_all = torch.from_numpy(verts_n).cuda()
        for i in range(0, len(pts_all), VERT_CHUNK):
            pts = pts_all[i:i + VERT_CHUNK]
            _, feat, grads = trainer.sdf_net.sdf_and_gradient(pts, vol_ft)
            nrm = grads / torch.sqrt((grads ** 2).sum(dim=-1, keepdim=True) + 1e-12)
            pix_c, pix_m = pixel_warp(pts, src, base["w2cs"], base["intrinsics"], (256, 256))
            colors.append(trainer.blend_net(pts, nrm, nrm, feat, pix_c, pix_m.float())[0])
    colors = torch.cat(colors).clamp(0, 1).cpu().numpy() if colors else np.zeros((0, 3))
    mesh_s = time.perf_counter() - t0
    mesh = {"vertices": mesh_extract.apply_mesh_transforms(verts_n, cams.get("scale_mat"),
                                                            cams.get("trans_mat")),
            "faces": faces, "colors": colors}
    check_mesh("finetune", mesh)
    log(
        f"phase finetune: R={R} mesh of the finetuned volume and SDF MLP, coloured by the "
        f"finetuned blending net: {len(verts_n)} vertices, {len(faces)} faces, colours in "
        f"[{colors.min():.3f}, {colors.max():.3f}], {mesh_s:.3f} s"
    )
    del trainer, stage, stage_ft
    log("phase finetune (card vs CPU): f32 vs CPU f32 and f64, TF32 off, "
        f"{len(FT_CHECK['views'])} source views, {FT_CHECK['vol_dims'][0]}^3, "
        f"{FT_CHECK['n_rays']} rays, full widths: " + finetune_check(recon_p, images, cams))


# ------------------------------------------------------------ train_zero123
def zero123_views():
    """Z123_OBJECTS objects x Z123_VIEWS seeded RGBA renders at Z123_SIZE^2
    (PNG bytes from the port's encoder) and their cameras (spherical_look_at_poses
    on a 1.5 sphere, [3, 4])."""
    import numpy as np

    from one2345_tpu_torch.geometry.cameras import spherical_look_at_poses
    from one2345_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[:Z123_SIZE, :Z123_SIZE] / Z123_SIZE
    objects = []
    for _ in range(Z123_OBJECTS):
        polar = np.radians(rng.uniform(30, 120, Z123_VIEWS))
        azim = np.radians(rng.uniform(0, 360, Z123_VIEWS))
        c2ws = spherical_look_at_poses(polar, azim, radius=1.5)
        views = []
        for v in range(Z123_VIEWS):
            cx, cy, r = rng.uniform(0.35, 0.65), rng.uniform(0.35, 0.65), rng.uniform(0.2, 0.35)
            a = np.clip(255 * (r - np.hypot(xx - cx, yy - cy)) / 0.02, 0, 255)
            rgb = np.stack([xx, yy, 0.5 + 0.5 * np.sin(9 * xx * yy + v)], -1) * 255
            img = np.concatenate([rgb + rng.integers(0, 20, rgb.shape), a[..., None]], -1)
            views.append((encode_png(np.clip(img, 0, 255).astype(np.uint8)),
                          c2ws[v, :3, :4].astype(np.float32)))
        objects.append(views)
    return objects


def write_zero123_data(root: str) -> tuple[str, str]:
    """The objects as per-object folders (views/obj<i>/NNN.png, .npy) and as
    two tar shards (shards/shard_00<k>.tar); returns the two roots."""
    import io
    import tarfile

    import numpy as np

    views_root, shards_root = os.path.join(root, "views"), os.path.join(root, "shards")
    os.makedirs(shards_root)
    objects = zero123_views()
    per = len(objects) // 2
    for k in range(2):
        with tarfile.open(os.path.join(shards_root, f"shard_{k:03d}.tar"), "w") as tf:
            for o in range(k * per, (k + 1) * per):
                d = os.path.join(views_root, f"obj{o}")
                os.makedirs(d)
                for v, (png, c2w) in enumerate(objects[o]):
                    buf = io.BytesIO()
                    np.save(buf, c2w)
                    for ext, payload in ((".png", png), (".npy", buf.getvalue())):
                        with open(os.path.join(d, f"{v:03d}{ext}"), "wb") as fh:
                            fh.write(payload)
                        info = tarfile.TarInfo(f"obj{o}/{v:03d}{ext}")
                        info.size = len(payload)
                        tf.addfile(info, io.BytesIO(payload))
    return views_root, shards_root


def phase_train_zero123(params, smi):
    """Phase 16: train_zero123.main at full width (DiffusionConfig(), B=8,
    remat, bf16 autocast) on phase 13's seeded weights, from the folders and
    from the shards: launches, seconds per step, samples/s, peak memory,
    metrics.jsonl, the sample grid and the checkpoint read back;
    --model_shards 2 refused by create_mesh in a world of one."""
    import shutil

    import torch

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.ddim import trim_for_sample
    from one2345_tpu_torch.diffusion.schedule import make_ddim_schedule
    from one2345_tpu_torch.ops.flash_attention import flash_attention as f
    from one2345_tpu_torch.training import train_zero123
    from one2345_tpu_torch.utils.png import read_png

    root = os.path.join(SCENES_OUT, "zero123")
    t0 = time.perf_counter()
    views_root, shards_root = write_zero123_data(root)
    init = os.path.join(root, "init.pt")
    checkpoint.save(init, params)
    prep_s = time.perf_counter() - t0
    cfg = DiffusionConfig()
    evals = len(trim_for_sample(make_ddim_schedule(Z123_SAMPLE_STEPS, cfg.timesteps, cfg.ddim_eta,
                                                   cfg.linear_start, cfg.linear_end)).timesteps)
    samples = sum(1 for s in range(1, Z123_STEPS) if s % Z123_SAMPLE_EVERY == 0)
    # every multi-token self-attention: 16 per UNet eval forward, twice that
    # with the remat recompute, dq and dkv once per layer in the backward
    expected = (32 * Z123_STEPS + 16 * evals * samples, 16 * Z123_STEPS, 16 * Z123_STEPS)
    log(f"phase train_zero123: {Z123_OBJECTS} objects x {Z123_VIEWS} RGBA views at "
        f"{Z123_SIZE}^2 (port PNG encoder) as folders and two tar shards, init params saved, "
        f"in {prep_s:.1f} s; {samples} log_samples grid of {evals} UNet evals")
    for name, data_root in (("folders", views_root), ("shards", shards_root)):
        exp = os.path.join(root, f"exp_{name}")
        argv = ["--data_root", data_root, "--init_params", init, "--batch_size", str(TRAIN_BATCH),
                "--max_steps", str(Z123_STEPS), "--log_every", "1", "--ckpt_every", "2",
                "--sample_every", str(Z123_SAMPLE_EVERY), "--sample_views", "4",
                "--sample_steps", str(Z123_SAMPLE_STEPS), "--exp_dir", exp]
        torch.cuda.reset_peak_memory_stats()
        f.launch_count = f.dq_launch_count = f.dkv_launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_zero123.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = (f.launch_count, f.dq_launch_count, f.dkv_launch_count)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if counts != expected:
            fail(f"train_zero123 ({name}): K1/dq/dkv launches {counts}, expected {expected}")
        recs = read_metrics(os.path.join(exp, "metrics.jsonl"))
        if [r["step"] for r in recs] != list(range(Z123_STEPS)) or not all(
                math.isfinite(r["loss"]) and r["samples_per_sec"] > 0 for r in recs):
            fail(f"train_zero123 ({name}): metrics {recs}")
        grid = read_png(os.path.join(exp, "samples", f"step_{Z123_SAMPLE_EVERY:06d}.png"))
        if grid.shape != (768, 1024, 3) or grid.std() == 0:
            fail(f"train_zero123 ({name}): sample grid {grid.shape}, std {grid.std()}")
        names = sorted(os.listdir(exp))
        if names != ["metrics.jsonl", "samples", "step_000002", f"step_{Z123_STEPS:06d}"]:
            fail(f"train_zero123 ({name}): {names} in the run's directory")
        state = checkpoint.restore(os.path.join(exp, f"step_{Z123_STEPS:06d}"))
        for key, module in trainer.modules.items():
            module.load_state_dict(state[key], strict=True)
        if trainer.step != Z123_STEPS or set(state) != {"unet", "cc_projection"}:
            fail(f"train_zero123 ({name}): step {trainer.step}, checkpoint keys {sorted(state)}")
        secs = [TRAIN_BATCH / r["samples_per_sec"] for r in recs]
        log(
            f"phase train_zero123 ({name}): main {' '.join(argv[4:-2])}: {total:.2f} s in all "
            f"(stage, trainer and data set-up, steps, grid, checkpoints), seconds per step "
            + ", ".join(f"{s:.3f}" for s in secs)
            + f" (step 0 cold, step {Z123_SAMPLE_EVERY} with the grid), samples/s "
            + ", ".join(f"{r['samples_per_sec']:.2f}" for r in recs)
            + f", loss " + ", ".join(f"{r['loss']:.4f}" for r in recs)
            + f" | K1/dq/dkv launches {counts} (expected {expected}) | grid 768x1024x3 read "
            f"back, step_{Z123_STEPS:06d} reloaded strict | peak mem {peak:.2f} GiB | {smi}"
        )
        del trainer, state
        shutil.rmtree(exp)
    try:
        train_zero123.main(["--data_root", views_root, "--model_shards", "2"])
    except ValueError as e:
        refusal = str(e)
    else:
        fail("train_zero123: --model_shards 2 was not refused in a world of one")
    if "!= 1 devices" not in refusal:
        fail(f"train_zero123: --model_shards 2 refused with {refusal!r}")
    log(f"phase train_zero123: --model_shards 2 refused in a world of one (create_mesh): "
        f"{refusal}")
    return counts


# --------------------------------------------------------------------- eval
def covering_faces(verts, faces, K, w2c, x: int, y: int):
    """(float64 depths, least barycentrics) of the faces whose triangle holds
    the centre of pixel (x, y) within RASTER_TIE, by the rasteriser's
    formulas (numpy, for the tie check)."""
    import numpy as np

    vc = verts.astype(np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
    uvw = vc @ K.T
    z = uvw[:, 2]
    uv = uvw[:, :2] / np.maximum(z[:, None], 1e-6)
    p, tz = uv[faces], z[faces]
    m00, m01 = p[:, 1, 0] - p[:, 0, 0], p[:, 2, 0] - p[:, 0, 0]
    m10, m11 = p[:, 1, 1] - p[:, 0, 1], p[:, 2, 1] - p[:, 0, 1]
    det = m00 * m11 - m01 * m10
    ok = (tz > 1e-4).all(axis=1) & (np.abs(det) >= 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        d0, d1 = x + 0.5 - p[:, 0, 0], y + 0.5 - p[:, 0, 1]
        b1 = (d0 * m11 - d1 * m01) / det
        b2 = (-d0 * m10 + d1 * m00) / det
    b = np.stack([1.0 - b1 - b2, b1, b2], axis=-1)
    cover = ok & (b.min(axis=1) >= -RASTER_TIE)
    return (b * tz).sum(axis=1)[cover], b.min(axis=1)[cover]


def raster_card_vs_cpu(verts, faces, colors, view: int) -> str:
    """One eval view rasterised on the card and on the CPU: equal pixels but
    at ties (two covering faces' depths within RASTER_TIE relative, or the
    pixel centre within RASTER_TIE of a covering face's edge)."""
    import numpy as np

    from one2345_tpu_torch.eval.render_harness import eval_cameras, rasterize

    K, w2c = eval_cameras(256)[view]
    t0 = time.perf_counter()
    card = rasterize(verts, faces, colors, K, w2c, 256, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = rasterize(verts, faces, colors, K, w2c, 256, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = (np.abs(card[0] - cpu[0]).max(axis=-1) > 0) | (card[1] != cpu[1])
    for y, x in np.argwhere(diff):
        depths, bmin = covering_faces(verts, faces, K, w2c, x, y)
        d = np.sort(depths)
        if not ((len(d) > 1 and d[1] - d[0] <= RASTER_TIE * d[0])
                or (np.abs(bmin) <= RASTER_TIE).any()):
            fail(f"eval: view {view} card vs CPU differs at pixel ({x}, {y}), no tie: depths "
                 f"{d[:3]}, least barycentrics {bmin}")
    return (f"view {view} at 256^2 card vs CPU: {int(diff.sum())} of {diff.size} pixels differ "
            f"(all at ties within {RASTER_TIE}), {float(card[1].mean()):.4f} covered; card "
            f"{card_s:.3f} s, CPU {cpu_s:.3f} s")


def phase_eval(mesh, smi):
    """Phase 17: sweep.main on phase 9's mesh as its own GT (.glb): the
    identical pair (.glb), a copy with each vertex moved 0.02 in a seeded
    direction (.obj) and the identical mesh as .ply (8-bit colours, read
    as [0, 1]), with
    --render_dir and the bare --clip_params (the seeded ViT-L/14 tower,
    bf16); the renders read back, one view card against CPU, seconds per
    pair and per 24 views."""
    import numpy as np
    import torch

    from one2345_tpu_torch.eval import metrics, render_harness, sweep
    from one2345_tpu_torch.pipeline.runner import save_obj
    from one2345_tpu_torch.recon.gltf import save_glb
    from one2345_tpu_torch.recon.mesh_extract import save_ply
    from one2345_tpu_torch.utils.png import read_png

    v = np.asarray(mesh["vertices"], np.float32)
    f, c = np.asarray(mesh["faces"], np.int32), np.asarray(mesh["colors"], np.float32)
    root = os.path.join(SCENES_OUT, "eval")
    pred, gt, renders = (os.path.join(root, d) for d in ("pred", "gt", "renders"))
    os.makedirs(pred), os.makedirs(gt)
    rng = np.random.default_rng(23)
    step = rng.normal(size=v.shape)
    moved = (v + EVAL_MOVE * step / np.linalg.norm(step, axis=1, keepdims=True)).astype(np.float32)
    for name in ("same", "moved", "ply"):
        save_glb(os.path.join(gt, f"{name}_gt.glb"), v, f, c)
    save_glb(os.path.join(pred, "same_ours.glb"), v, f, c)
    save_obj(os.path.join(pred, "moved_ours.obj"), moved, f, c)
    save_ply(os.path.join(pred, "ply_ours.ply"), v, f, (c * 255).astype(np.uint8))
    out = os.path.join(root, "table.json")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = sweep.main(["--pred_dir", pred, "--gt_dir", gt, "--out", out, "--render_dir",
                        renders, "--clip_params"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = {r["name"]: r for r in table["per_mesh"]}
    same, mv = rows.get("same"), rows.get("moved")
    if table["n_pairs"] != 3 or sorted(rows) != ["moved", "ply", "same"]:
        fail(f"eval: pairs {sorted(rows)}")
    if not (same["chamfer_l2"] < EVAL_SAME_CD and same["f_score"] == 1.0
            and abs(same["clip_sim"] - 1.0) <= EVAL_CLIP_TOL):
        fail(f"eval: the identical pair {same}")
    if not (mv["chamfer_l2"] > same["chamfer_l2"] and mv["chamfer_l1"] > same["chamfer_l1"]
            and mv["f_score"] <= same["f_score"] and mv["clip_sim"] < same["clip_sim"]):
        fail(f"eval: the moved pair {mv} is not worse than the identical pair {same}")
    if not rows["ply"]["clip_sim"] >= EVAL_PLY_CLIP:
        fail(f"eval: the identical mesh as .ply scores clip_sim {rows['ply']['clip_sim']} "
             f"(>= {EVAL_PLY_CLIP})")
    with open(out) as fh:
        if json.load(fh) != json.loads(json.dumps(table)):
            fail("eval: the written table differs from the returned one")
    for name in rows:
        pngs = sorted(os.listdir(os.path.join(renders, name)))
        if pngs != [f"{i:03d}.png" for i in range(24)]:
            fail(f"eval: renders of {name}: {pngs}")
        shapes = {read_png(os.path.join(renders, name, p)).shape for p in pngs}
        if shapes != {(256, 256, 3)}:
            fail(f"eval: render shapes of {name}: {shapes}")
    vn = metrics.normalize_to_unit_box(v, 0.8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    views = render_harness.render_eval_views(*sweep.load_mesh(os.path.join(pred, "same_ours.glb")))
    torch.cuda.synchronize()
    views_s = time.perf_counter() - t0
    again = read_png(os.path.join(renders, "same", "005.png"))
    if not np.array_equal(again, (np.clip(views[5], 0, 1) * 255).astype(np.uint8)):
        fail("eval: render 005 of the identical pair does not read back as rendered")
    t0 = time.perf_counter()
    metrics.evaluate_mesh_pair(moved, f, v, f)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    log(
        f"phase eval: sweep.main --render_dir --clip_params (seeded ViT-L/14, bf16) on phase 9's "
        f"mesh ({len(v)} vertices, {len(f)} faces) as its own GT: {total:.2f} s for 3 pairs "
        f"({total / 3:.2f} s per pair with 48 renders and 48 CLIP embeddings), identical pair "
        f"chamfer_l2 {same['chamfer_l2']:.3e} (sampling floor, < {EVAL_SAME_CD}), f_score "
        f"{same['f_score']}, clip_sim {same['clip_sim']:.7f}; moved by {EVAL_MOVE}: chamfer_l2 "
        f"{mv['chamfer_l2']:.3e}, chamfer_l1 {mv['chamfer_l1']:.3e}, f_score "
        f"{mv['f_score']:.4f}, clip_sim {mv['clip_sim']:.5f}; .ply (8-bit colours scaled by "
        f"1/255): clip_sim {rows['ply']['clip_sim']:.5f} (>= {EVAL_PLY_CLIP}); 3 x 24 "
        f"renders read back | evaluate_mesh_pair alone {pair_s:.3f} s (16384 points, float64 "
        f"nearest neighbours), render_eval_views 24 views at 256^2 {views_s:.3f} s | peak mem "
        f"{peak:.2f} GiB | {smi}"
    )
    log("phase eval: " + raster_card_vs_cpu(vn, f, c, 5))


# ------------------------------------------------------------------ convert
# The seeded weights under the reference's key names and in its layouts:
# phase 18 writes them as the reference's checkpoint files and converts them
# back with utils/convert_cli.py.  The JAX package has no inverse of its
# converter, so the port has none; tests/test_torch_convert_weights.py holds
# these functions against the JAX converter.
UNET_PARTS = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb_proj": "emb_layers.1",
              "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip": "skip_connection",
              "block0": "transformer_blocks.0", "to_out": "to_out.0", "ff_geglu": "ff.net.0",
              "ff_out": "ff.net.2"}
CLIP_RULES = ((r"(class_embedding|positional_embedding|proj)$", r"\1"), (r"patch_embed\.", "conv1."),
              (r"(ln_pre|ln_post)\.", r"\1."), (r"resblock_(\d+)\.", r"transformer.resblocks.\1."))
CLIP_PARTS = {"fc": "mlp.c_fc", "proj": "mlp.c_proj"}
SAM_RULES = (
    (r"encoder\.pos_embed$", "image_encoder.pos_embed"),
    (r"encoder\.patch_embed\.", "image_encoder.patch_embed.proj."),
    (r"encoder\.neck_conv1\.", "image_encoder.neck.0."),
    (r"encoder\.neck_ln1\.", "image_encoder.neck.1."),
    (r"encoder\.neck_conv2\.", "image_encoder.neck.2."),
    (r"encoder\.neck_ln2\.", "image_encoder.neck.3."),
    (r"encoder\.block_(\d+)\.", r"image_encoder.blocks.\1."),
    (r"decoder\.(iou_token|mask_tokens)$", r"mask_decoder.\1.weight"),
    (r"decoder\.layer(\d)\.", r"mask_decoder.transformer.layers.\1."),
    (r"decoder\.final_attn\.", "mask_decoder.transformer.final_attn_token_to_image."),
    (r"decoder\.norm_final\.", "mask_decoder.transformer.norm_final_attn."),
    (r"decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"decoder\.upscale_ln\.", "mask_decoder.output_upscaling.1."),
    (r"decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
    (r"decoder\.iou_head\.lin(\d)\.", r"mask_decoder.iou_prediction_head.layers.\1."),
    (r"decoder\.hyper_(\d)\.lin(\d)\.", r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (r"extra\.pe_gaussian$", "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
)
SAM_PARTS = {"mlp_lin1": "mlp.lin1", "mlp_lin2": "mlp.lin2",
             "cross_attn_t2i": "cross_attn_token_to_image",
             "cross_attn_i2t": "cross_attn_image_to_token"}
LOFTR_RULES = (
    (r"backbone\.layer(\d)_(\d)\.down_conv\.", r"backbone.layer\1.\2.downsample.0."),
    (r"backbone\.layer(\d)_(\d)\.down_bn\.", r"backbone.layer\1.\2.downsample.1."),
    (r"backbone\.layer(\d)_(\d)\.", r"backbone.layer\1.\2."),
    (r"backbone\.layer(\d)_outconv2_0\.", r"backbone.layer\1_outconv2.0."),
    (r"backbone\.layer(\d)_outconv2_bn\.", r"backbone.layer\1_outconv2.1."),
    (r"backbone\.layer(\d)_outconv2_1\.", r"backbone.layer\1_outconv2.3."),
    (r"backbone\.", "backbone."),
    # layer_names = ['self', 'cross'] * 4: layers[2i] = self_i, layers[2i+1] = cross_i
    (r"coarse_tf\.self_(\d)\.", lambda m: f"loftr_coarse.layers.{2 * int(m[1])}."),
    (r"coarse_tf\.cross_(\d)\.", lambda m: f"loftr_coarse.layers.{2 * int(m[1]) + 1}."),
    (r"fine_tf\.self_0\.", "loftr_fine.layers.0."),
    (r"fine_tf\.cross_0\.", "loftr_fine.layers.1."),
    (r"(down_proj|merge_feat)\.", r"fine_preprocess.\1."),
)
LOFTR_PARTS = {"mlp0": "mlp.0", "mlp2": "mlp.2"}
# FeatureNet's ConvBnAct_0..7: conv0.{0,1}, conv1.{0,1,2}, conv2.{0,1,2}
FPN_CONVS = [(f"conv{c}", i) for c, n in ((0, 2), (1, 3), (2, 3)) for i in range(n)]
COSTREG_CONVS = {"_MConvBnRelu": list(range(7)), "_MDeconvBnRelu": [7, 9, 11]}
RENDER_FCS = {"ray_dir_fc0": "ray_dir_fc.0", "ray_dir_fc1": "ray_dir_fc.2", "base_fc0": "base_fc.0",
              "base_fc1": "base_fc.2", "vis_fc0": "vis_fc.0", "vis_fc1": "vis_fc.2",
              "vis_fc2_0": "vis_fc2.0", "vis_fc2_1": "vis_fc2.2", "rgb_fc0": "rgb_fc.0",
              "rgb_fc1": "rgb_fc.2", "rgb_fc2": "rgb_fc.4"}
INPLACE_ABN_EPS = 1e-5
# the reference's file names, under _smoke_scenes/convert/
CONVERT_FILES = {"zero123": "zero123-xl.ckpt", "sam": "sam_vit_h_4b8939.pth",
                 "loftr": "indoor_ds_new.ckpt", "recon": "ckpt_215000.pth",
                 "safety": "safety_checker.bin"}


def renamed(sd: dict, rules, parts=None, prefix: str = "") -> dict:
    """``sd`` under the reference's names: the first of ``rules`` (pattern,
    replacement string or function of the match) whose pattern matches the
    start of a key rewrites that start; then each dotted component of the
    rest that ``parts`` names is replaced."""
    out = {}
    for key, value in sd.items():
        for pattern, repl in rules:
            m = re.match(pattern, key)
            if m:
                break
        else:
            raise KeyError(f"no reference name for {key!r}")
        rest = [(parts or {}).get(c, c) for c in key[m.end():].split(".") if c]
        head = repl(m) if callable(repl) else m.expand(repl)
        out[prefix + head + ".".join(rest)] = value
    return out


def unet_rules(sd: dict) -> list:
    """The scopes of a UNet state dict (its levels and res blocks read off its
    keys) -> openaimodel.py's block numbering."""
    n = 1 + max(int(m[1]) for k in sd if (m := re.match(r"in_(\d+)_", k)))
    blocks = 1 + max(int(m[1]) for k in sd if (m := re.match(r"in_0_(\d+)_res\.", k)))
    scopes = {"time_embed_0": "time_embed.0", "time_embed_2": "time_embed.2",
              "conv_in": "input_blocks.0.0", "out_norm": "out.0", "conv_out": "out.2",
              "mid_res1": "middle_block.0", "mid_attn": "middle_block.1",
              "mid_res2": "middle_block.2"}
    idx = 1
    for level in range(n):
        for i in range(blocks):
            scopes[f"in_{level}_{i}_res"] = f"input_blocks.{idx}.0"
            scopes[f"in_{level}_{i}_attn"] = f"input_blocks.{idx}.1"
            idx += 1
        if level != n - 1:
            scopes[f"down_{level}"] = f"input_blocks.{idx}.0"
            idx += 1
    idx = 0
    for level in reversed(range(n)):
        for i in range(blocks + 1):
            scopes[f"out_{level}_{i}_res"] = f"output_blocks.{idx}.0"
            scopes[f"out_{level}_{i}_attn"] = f"output_blocks.{idx}.1"
            if i == blocks and level != 0:
                sub = 2 if any(k.startswith(f"out_{level}_{i}_attn.") for k in sd) else 1
                scopes[f"up_{level}"] = f"output_blocks.{idx}.{sub}"
            idx += 1
    return [(rf"{scope}\.", f"{ref}.") for scope, ref in scopes.items()]


def vae_rules(part: str) -> tuple:
    """The VAE encoder's or decoder's scopes -> the reference's."""
    return ((r"down_(\d+)_block_(\d+)\.", rf"{part}.down.\1.block.\2."),
            (r"down_(\d+)_downsample\.", rf"{part}.down.\1.downsample.conv."),
            (r"up_(\d+)_block_(\d+)\.", rf"{part}.up.\1.block.\2."),
            (r"up_(\d+)_conv\.", rf"{part}.up.\1.upsample.conv."),
            (r"mid_block_(\d)\.", rf"{part}.mid.block_\1."),
            (r"mid_attn\.", f"{part}.mid.attn_1."),
            (r"(post_quant_conv|quant_conv)\.", r"\1."),
            (r"", f"{part}."))


def reference_clip(sd: dict, prefix: str = "cond_stage_model.model.visual.") -> dict:
    """A CLIPVisionTower state dict as OpenAI's visual tower: q, k and v
    packed into each block's in_proj."""
    import torch

    sd = dict(sd)
    layers = 1 + max(int(m[1]) for k in sd if (m := re.match(r"resblock_(\d+)\.", k)))
    for i in range(layers):
        a = f"resblock_{i}.attn."
        for leaf in ("weight", "bias"):
            sd[f"{a}in_proj_{leaf}"] = torch.cat([sd.pop(f"{a}{x}_proj.{leaf}") for x in "qkv"])
    return renamed(sd, CLIP_RULES, CLIP_PARTS, prefix)


def reference_zero123(z: dict) -> dict:
    """The Zero123 stage's state dicts as a Lightning LatentDiffusion
    checkpoint (zero123-xl.ckpt's container and keys, without EMA)."""
    sd = renamed(z["unet"], unet_rules(z["unet"]), UNET_PARTS, "model.diffusion_model.")
    for part in ("encoder", "decoder"):
        sd.update(renamed(z[part], vae_rules(part), prefix="first_stage_model."))
    sd.update(reference_clip(z["clip"]))
    sd["cc_projection.weight"] = z["cc_projection"]["kernel"].T
    sd["cc_projection.bias"] = z["cc_projection"]["bias"]
    return {"epoch": 0, "global_step": 0, "state_dict": sd}


def with_ema(sd: dict, keep: str) -> dict:
    """A LatentDiffusion state dict with LitEma's twins ('model_ema.' and the
    name with every dot dropped): each UNet weight moves to its twin and a
    zero placeholder of no memory takes its raw name, except ``keep``, which
    keeps its raw weight and gets no twin."""
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith("model.diffusion_model.") and k != keep:
            out["model_ema." + k[len("model."):].replace(".", "")] = v
            out[k] = v.new_zeros(()).expand(v.shape)
    return out


def reference_sam(sd: dict) -> dict:
    """A SamModules state dict as sam_vit_h_4b8939.pth's bare state dict."""
    sd = dict(sd)
    box = sd.pop("extra.box_embed")
    out = renamed(sd, SAM_RULES, SAM_PARTS)
    for i in (2, 3):
        out[f"prompt_encoder.point_embeddings.{i}.weight"] = box[i - 2:i - 1]
    return out


def reference_loftr(sd: dict) -> dict:
    """A LoFTRModules state dict as indoor_ds_new.ckpt: Lightning's
    container, every key under 'matcher.'."""
    return {"epoch": 0, "global_step": 0,
            "state_dict": renamed(sd, LOFTR_RULES, LOFTR_PARTS, "matcher.")}


def inplace_abn_gamma(scale):
    """An InPlaceABN gamma whose effective scale |gamma| + 1e-5 is ``scale``
    (> 1e-5) exactly in f32; every other gamma negative."""
    import torch

    if not (scale > INPLACE_ABN_EPS).all():
        raise ValueError("an InPlaceABN scale must exceed its eps")
    g = scale - INPLACE_ABN_EPS
    for _ in range(8):  # the f32 sum is monotone in gamma: step by ulps to the exact one
        r = g + INPLACE_ABN_EPS
        if torch.equal(r, scale):
            break
        g = torch.where(r < scale, torch.nextafter(g, torch.full_like(g, math.inf)),
                        torch.where(r > scale, torch.nextafter(g, torch.zeros_like(g)), g))
    else:
        raise ValueError("no f32 gamma gives these InPlaceABN scales")
    return g * (1 - 2 * (torch.arange(len(g)) % 2)).to(g.dtype)


def torchsparse_kernel(w, transposed: bool):
    """A Conv3d weight (O, I, kx, ky, kz) as torchsparse's kernel [k^3, I, O]
    (offsets with x varying fastest; a transposed conv's taps flipped)."""
    w = w.permute(2, 3, 4, 1, 0)
    if transposed:
        w = w.flip(0, 1, 2)
    return w.permute(2, 1, 0, 3, 4).reshape(-1, w.shape[3], w.shape[4])


def reference_recon(params: dict) -> dict:
    """ReconStage's state dicts as ckpt_215000.pth: a dict of per-network
    state dicts, lod0 and (where ``params`` has them) lod1, with InPlaceABN
    gammas, torchsparse kernels and weight_norm's weight_v / weight_g."""
    out = {}
    for lod, s in (("lod0", ""), ("lod1", "_lod1")):
        if f"sdf{s}" not in params:
            continue
        fpn = {}
        for key, v in params[f"fusion{s}"].items():
            m = re.match(r"fpn\.ConvBnAct_(\d+)\.(Conv_0|BatchNorm_0)\.(\w+)$", key)
            if not m:
                fpn[key[len("fpn."):]] = v
                continue
            conv, i = FPN_CONVS[int(m[1])]
            layer = "conv" if m[2] == "Conv_0" else "bn"
            fpn[f"{conv}.{i}.{layer}.{m[3]}"] = (
                inplace_abn_gamma(v) if (layer, m[3]) == ("bn", "weight") else v)
        sdf = {}
        for key, v in params[f"sdf{s}"].items():
            if m := re.match(r"compress\.(Conv_0|BatchNorm_0)\.(\w+)$", key):
                layer = "conv" if m[1] == "Conv_0" else "bn"
                sdf[f"compress_layer.{layer}.{m[2]}"] = (
                    inplace_abn_gamma(v) if (layer, m[2]) == ("bn", "weight") else v)
            elif m := re.match(r"costreg\.(_M\w+)_(\d)\.Conv_0\.weight$", key):
                name = f"conv{COSTREG_CONVS[m[1]][int(m[2])]}"
                sdf[f"sparse_costreg_net.{name}.net.0.kernel"] = torchsparse_kernel(
                    v, transposed=m[1] == "_MDeconvBnRelu")
            elif m := re.match(r"costreg\.(_M\w+)_(\d)\.MaskedBatchNorm_0\.(\w+)$", key):
                name = f"conv{COSTREG_CONVS[m[1]][int(m[2])]}"
                sdf[f"sparse_costreg_net.{name}.net.1.{m[3]}"] = v
            elif m := re.match(r"sdf_layer\.(lin\d)\.v$", key):
                sdf[f"sdf_layer.{m[1]}.weight_v"] = v.T
            elif m := re.match(r"sdf_layer\.(lin\d)\.g$", key):
                sdf[f"sdf_layer.{m[1]}.weight_g"] = v[:, None]
            elif key.startswith("sdf_layer.") and key.endswith(".bias"):
                sdf[key] = v
            else:
                raise KeyError(f"no reference name for sdf{s} {key!r}")
        render = {"s": params[f"render{s}"]["s"].reshape(1)}
        render.update(renamed({k: v for k, v in params[f"render{s}"].items() if k != "s"},
                              [(rf"{k}\.", f"{v}.") for k, v in RENDER_FCS.items()]))
        out[f"pyramid_feature_network_{lod}"] = fpn
        out[f"sdf_network_{lod}"] = sdf
        out[f"rendering_network_{lod}"] = render
        out[f"variance_network_{lod}"] = dict(params[f"variance{s}"])
    return out


def safety_state_dict() -> dict:
    """A seeded HF safety-checker state dict: 3 concept and 2 special-care
    embeddings whose thresholds (0.5, 0.6 once scaled) no image reaches."""
    import numpy as np
    import torch

    rng = np.random.default_rng(46)
    return {
        "concept_embeds": torch.from_numpy(rng.standard_normal((3, 768)).astype(np.float32)),
        "concept_embeds_weights": torch.full((3,), 0.5),
        "special_care_embeds": torch.from_numpy(rng.standard_normal((2, 768)).astype(np.float32)),
        "special_care_embeds_weights": torch.full((2,), 0.5),
    }


def reference_checkpoints(stages: dict, sam_w: dict) -> dict:
    """The weights of phase 11's CLI run (the stages' state dicts, SAM's and
    ``safety_state_dict()``) -> {name: the reference's checkpoint object}."""
    return {
        "zero123": reference_zero123(stages["zero123"]),
        "sam": reference_sam(sam_w),
        "loftr": reference_loftr(stages["loftr"]),
        "recon": reference_recon(stages["recon"]),
        "safety": safety_state_dict(),
    }


def tree_leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from tree_leaves(value)
    else:
        yield tree


def tree_differences(got, want, path: str = "") -> list:
    """The paths at which two trees of tensors and scalars differ: keys,
    dtypes, shapes or any bit."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path} (keys)"]
        return [d for k in want for d in tree_differences(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, torch.Tensor):
        same = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.shape == want.shape and torch.equal(
                    got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)))
    else:
        same = type(got) is type(want) and got == want
    return [] if same else [path]


def phase_convert(stages: dict, sam_w: dict, dpmpp_run, smi):
    """Phase 18: phase 11's parameter tree written as the reference's five
    checkpoint files, converted by utils/convert_cli.py in its own process,
    read back and held against the tree bit for bit; the UNet's EMA remap at
    full width in memory; then cli.main --params on the converted file with
    --sampler dpmpp, held against phase 12's --sampler dpmpp run on the
    in-memory tree.  The reference-format files stay under
    _smoke_scenes/convert/ckpts/ for phase 24; returns that directory."""
    import shutil

    import numpy as np
    import torch

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.utils import convert_weights as cw

    root = os.path.join(SCENES_OUT, "convert")
    ckpts = os.path.join(root, "ckpts")
    os.makedirs(ckpts, exist_ok=True)
    out = os.path.join(root, "params.pt")
    try:
        refs = reference_checkpoints(stages, sam_w)
        # the EMA weights win over the raw ones, and a UNet key without a
        # twin falls back to its raw weight
        z = refs["zero123"]["state_dict"]
        keep = "model.diffusion_model.out.2.bias"
        t0 = time.perf_counter()
        unet = cw.convert_zero123(with_ema(z, keep))["unet"]
        ema_s = time.perf_counter() - t0
        if diff := tree_differences(unet, stages["zero123"]["unet"]):
            fail(f"convert: the EMA UNet differs from the seeded one at {diff[:5]}")
        del unet, z
        written = {}
        for name, obj in refs.items():
            path = os.path.join(ckpts, CONVERT_FILES[name])
            t0 = time.perf_counter()
            torch.save(obj, path)
            written[name] = (path, time.perf_counter() - t0)
        del refs
        argv = [sys.executable, "-m", "one2345_tpu_torch.utils.convert_cli"]
        for name, (path, _) in written.items():
            argv += [f"--{name}", path]
        t0 = time.perf_counter()
        res = subprocess.run(argv + ["--out", out], cwd=REPO, capture_output=True, text=True,
                             timeout=900)
        convert_s = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"convert: convert_cli exited {res.returncode}: {res.stderr[-2000:]}")
        per_file = re.findall(r"converted (\w+): .* \((\d+) bytes\): load ([\d.]+) s, convert "
                              r"([\d.]+) s", res.stdout)
        saved = re.search(r"saved .* \((\d+) bytes\) in ([\d.]+) s", res.stdout)
        if sorted(f[0] for f in per_file) != sorted(written) or not saved:
            fail(f"convert: convert_cli printed {res.stdout!r}")
        t0 = time.perf_counter()
        restored = checkpoint.restore(out)
        restore_s = time.perf_counter() - t0
        want = cli_params(stages, sam_w)
        checker = want.pop("safety")
        want["safety"] = {
            "concept_embeds": torch.from_numpy(checker.concept_embeds),
            "concept_thresholds": torch.from_numpy(checker.concept_thresholds),
            "special_embeds": torch.from_numpy(checker.special_embeds),
            "special_thresholds": torch.from_numpy(checker.special_thresholds),
            "threshold_scale": 1.0,
        }
        if diff := tree_differences(restored, want):
            fail(f"convert: the converted tree differs from phase 11's at {diff[:5]}")
        n_tensors = sum(isinstance(x, torch.Tensor) for x in tree_leaves(want))
        del restored
        log("phase convert: the reference's checkpoints of phase 11's seeded weights, written "
            "with torch.save (" + ", ".join(
                f"{CONVERT_FILES[n]} {int(b) / 2**30:.3f} GiB in {written[n][1]:.2f} s"
                for n, b, _, _ in per_file)
            + f"); utils.convert_cli in its own process: {convert_s:.2f} s in all, per file load "
            + ", ".join(f"{n} {float(ld):.2f} s + convert {float(cv):.3f} s"
                        for n, _, ld, cv in per_file)
            + f", saved {int(saved[1]) / 2**30:.3f} GiB in {float(saved[2]):.2f} s; restored "
            f"(weights_only) in {restore_s:.2f} s: {n_tensors} tensors equal to phase 11's tree "
            f"bit for bit; the EMA remap at full width in memory ({ema_s:.2f} s): EMA weights "
            f"win, {keep} without a twin keeps its raw weight | {smi}")

        img_path, raw = cli_input()
        expected = 16 * DPMPP_EVALS
        run = cli_run("convert cli", ["--sampler", "dpmpp", "--params", out], img_path, raw,
                      None, expected)
        res, ref = run[0], dpmpp_run[0]
        if res.elevation != ref.elevation:
            fail(f"convert cli: elevation {res.elevation}, phase 12's {ref.elevation}")
        images = max(float((a - b).abs().max()) for a, b in (
            (res.stage1_images, ref.stage1_images), (res.stage2_images, ref.stage2_images)))
        same_mesh = (np.array_equal(res.vertices, ref.vertices)
                     and np.array_equal(res.faces, ref.faces)
                     and np.array_equal(res.colors, ref.colors))
        if images != 0.0 or not same_mesh:
            fail(f"convert cli: stage images max abs {images} from phase 12's dpmpp run, mesh "
                 f"{len(res.vertices)} / {len(ref.vertices)} vertices, equal {same_mesh}")
        log("phase convert: cli.main --sampler dpmpp --params <converted file> on the phase-11 "
            "PNG (SAM on, gate loaded from the file): " + cli_line(*run[:3], expected, *run[3:])
            + f" | stage images and mesh equal to phase 12's --sampler dpmpp run on the "
            f"in-memory tree | {smi}")
    finally:
        if os.path.exists(out):
            os.remove(out)
        shutil.rmtree(PIPELINE_OUT, ignore_errors=True)
    return ckpts


# --------------------------------------------------------------- multi-card
# The multi-card paths on the one card: a world of one over NCCL (phase 21,
# every path against its unsharded twin) and two gloo ranks on cuda:0
# (phase 22: gloo's all-reduce, broadcast and all-gather take CUDA tensors;
# NCCL refuses two ranks on one card), then bf16 reconstruction training
# (phase 23).  The sharded Zero123 steps compare at base lr 1e-2 (the
# CPU parity tests' choice), which lifts the second step's update (lr 1e-4
# after the warmup's first 1e-8) far above the weights' f32 rounding.
MC_BASE_LR = 1e-2
MC_STEPS = 2
MC_LOSS_TOL = 1e-5  # relative, a sharded step's loss against the unsharded one's
MC_UPDATE_TOL = 5e-3  # relative L2 of each tensor's update and EMA change
MC_IMG_TOL = 2e-3  # max abs, a sharded sampling call's images against the unsharded's
MC_SAMPLE_STEPS = 25


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def recon_step_diff(metrics, ref_metrics, params, ref_params, lr: float) -> tuple:
    """(worst metric relative error, elements of the parameters beyond 4 lr,
    beyond 0.1 lr, their count, worst running-statistic abs error) of one
    reconstruction step's result against another's (state dicts, any
    device)."""
    worst_m = max(abs(float(metrics[k]) - float(v)) / max(abs(float(v)), 1e-30)
                  for k, v in ref_metrics.items())
    far = off = total = 0
    stats = 0.0
    for key, sd in ref_params.items():
        for name, ref in sd.items():
            d = (params[key][name].detach().cpu().double() - ref.detach().cpu().double()).abs()
            if "running" in name:
                stats = max(stats, float(d.max()))
                continue
            far += int((d > 4 * lr).sum())
            off += int((d > 0.1 * lr).sum())
            total += d.numel()
    return worst_m, far, off, total, stats


def check_recon_step(name: str, diff: tuple):
    worst_m, far, off, total, stats = diff
    if not (worst_m <= RECON_LOSS_TOL and far == 0 and off <= 0.005 * total
            and stats <= 1e-4):
        fail(f"{name}: metrics worst {worst_m}, {far} elements beyond 4 lr, {off} of {total} "
             f"beyond 0.1 lr, running stats {stats}")
    return (f"metrics worst rel {worst_m:.2e}, {off} of {total} parameter elements beyond "
            f"0.1 lr (none beyond 4 lr), running stats max abs {stats:.2e}")


def zero123_sharded_check(stage, params, mesh) -> tuple:
    """(a) the sharded Zero123 train step at DiffusionConfig(), B=8, on the
    (1, 1) mesh with the parameters fully_shard'ed, against the unsharded
    step from the same weights and generator draws.  Returns (line, the
    sharded steps' K1 / dq / dkv launches)."""
    import torch

    from one2345_tpu_torch.ops.flash_attention import flash_attention as f
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    batch = train_batch(TRAIN_BATCH)
    trainable = {k: params[k] for k in ("unet", "cc_projection")}
    one = Zero123Trainer(stage, trainable, remat=True, device="cuda", base_lr=MC_BASE_LR)
    ref_losses = [float(one.train_step(batch)) for _ in range(MC_STEPS)]
    ref_p, ref_e = one.state_dicts(), one.ema_state_dicts()
    del one
    sh = Zero123Trainer(stage, trainable, remat=True, device="cuda", base_lr=MC_BASE_LR)
    step = sh.make_sharded_train_step(mesh, shard_params=True)
    losses, secs, totals = [], [], [0, 0, 0]
    for i in range(MC_STEPS):
        torch.cuda.reset_peak_memory_stats()
        f.launch_count = f.dq_launch_count = f.dkv_launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = (f.launch_count, f.dq_launch_count, f.dkv_launch_count)
        if counts != (32, 16, 16):
            fail(f"multicard (a) step {i + 1}: K1/dq/dkv launches {counts}, expected (32, 16, 16)")
        totals = [a + b for a, b in zip(totals, counts)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    sharded = [p for p in sh._params if hasattr(p, "to_local")]
    if len(sharded) != len(sh._params) or not sh.optimizer.state:
        fail(f"multicard (a): {len(sharded)} of {len(sh._params)} parameters are DTensors")
    for a, b in zip(losses, ref_losses):
        if not (math.isfinite(a) and abs(a - b) <= MC_LOSS_TOL * abs(b)):
            fail(f"multicard (a): sharded losses {losses}, unsharded {ref_losses}")
    got_p, got_e = sh.state_dicts(), sh.ema_state_dicts()
    worst, worst_name, n = 0.0, "", 0
    for name, sd in ref_p.items():
        for k, ref in sd.items():
            w0 = trainable[name][k].to(ref.device)
            for got, want in ((got_p[name][k], ref), (got_e[name][k], ref_e[name][k])):
                d_ref = (want - w0).double()
                norm = float(d_ref.norm())
                if norm == 0:
                    if float((got - w0).abs().max()) != 0:
                        fail(f"multicard (a): {name}.{k} moved, its unsharded twin did not")
                    continue
                rel = float(((got - w0).double() - d_ref).norm()) / norm
                n += 1
                if rel > worst:
                    worst, worst_name = rel, f"{name}.{k}"
    if worst > MC_UPDATE_TOL:
        fail(f"multicard (a): update of {worst_name} {worst} from the unsharded step's")
    del sh, step, got_p, got_e, ref_p, ref_e
    return (f"(a) sharded Zero123 step, DiffusionConfig(), B={TRAIN_BATCH}, (data=1, model=1) "
            f"mesh, FSDP2 over model: losses {', '.join(f'{x:.6f}' for x in losses)} (unsharded "
            f"{', '.join(f'{x:.6f}' for x in ref_losses)}), {n} updates and EMA changes worst "
            f"relative L2 {worst:.2e} ({worst_name}) from the unsharded step's, seconds per "
            f"step {', '.join(f'{x:.3f}' for x in secs)}, K1/dq/dkv launches (32, 16, 16) per "
            f"step, peak mem {peak:.2f} GiB"), totals


def recon_world_one(cut: bool = False) -> tuple:
    """Phase 14's full-width config (ReconConfig(num_lods=2)), its seeded
    weights and its scene; with ``cut``, the config and scene of its
    card-against-CPU check (RECON_TRAIN_CHECK, RECON_TRAIN_VIEWS)."""
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.training.data import ReconScenesDataset

    cfg = ReconConfig(num_lods=2, **(RECON_TRAIN_CHECK if cut else {}))
    params = recon_params(seed=30, num_lods=2)
    ds = ReconScenesDataset(os.path.join(SCENES_OUT, "data"), n_rays=512)
    scene = ds.sample_scene(0, generator=torch.Generator().manual_seed(3))
    if cut:
        scene = {k: (v[RECON_TRAIN_VIEWS] if k in ("images", "affines", "w2cs", "intrinsics")
                     else v[:cfg.n_rays] if k.startswith("rays_") else v)
                 for k, v in scene.items()}
    return cfg, params, scene


def recon_unsharded_step(cfg, params, scene) -> tuple:
    """One unsharded step from a fresh trainer: (its metrics, its state on
    the host, the draws it took from the generator, its seconds)."""
    import torch

    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    one = ReconTrainer(ReconStage(cfg, params=params, device="cuda"), cfg)
    draws = {k: v.cpu() for k, v in one.scene_draws(len(scene["rays_o"])).items()}
    one.generator.manual_seed(0)  # the trainer's seed: the step draws the same
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = {k: float(v) for k, v in one.train_step(scene).items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    state = {k: {n: t.detach().cpu() for n, t in mod.state_dict().items()}
             for k, mod in one.modules.items()}
    return m, state, draws, dt


def recon_sharded_check(mesh) -> str:
    """(b) the sharded reconstruction step at phase 14's full width on the
    one-rank data mesh against the unsharded step (the same weights and
    generator draws): metrics, parameters and running statistics."""
    import torch

    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    cfg, params, scene = recon_world_one()
    ref_m, ref_state, _, ref_dt = recon_unsharded_step(cfg, params, scene)
    sh = ReconTrainer(ReconStage(cfg, params=params, device="cuda"), cfg)
    step = sh.make_sharded_train_step(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(scene)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: m_.state_dict() for k, m_ in sh.modules.items()}
    line = check_recon_step("multicard (b)", recon_step_diff(m, ref_m, got, ref_state,
                                                              cfg.learning_rate))
    return (f"(b) sharded recon step, ReconConfig(num_lods=2) at full width, one scene per "
            f"rank on the (data=1) mesh: loss {float(m['loss']):.6f} (unsharded "
            f"{ref_m['loss']:.6f}), {line}, {dt:.3f} s (unsharded, cold, {ref_dt:.3f} s)")


def sampler_sharded_check(stage, mesh) -> tuple:
    """(c) Zero123Stage stage 1 of views 0-3, then 4-11, sharded over the
    one-rank data mesh against the unsharded calls.  Returns (line, the
    unsharded images, the sharded calls' K1 launches)."""
    import torch

    from one2345_tpu_torch.ops.flash_attention import flash_attention as f

    image = input_image(stage.config.image_size)
    out, launches = {}, {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        stage.mesh = m
        f.launch_count = 0
        try:
            out[name] = [stage.stage1(image, 5, indices=idx, steps=MC_SAMPLE_STEPS)
                         for idx in ([0, 1, 2, 3], list(range(4, 12)))]
        finally:
            stage.mesh = None
        torch.cuda.synchronize()
        launches[name] = f.launch_count
    errs = [float((a - b).abs().max()) for a, b in zip(out["sharded"], out["unsharded"])]
    if max(errs) > MC_IMG_TOL or launches["sharded"] != launches["unsharded"] \
            or launches["sharded"] % 16 or not launches["sharded"]:
        fail(f"multicard (c): images max abs {errs}, K1 launches {launches}")
    return (f"(c) Zero123Stage(mesh) stage 1 of views 0-3 then 4-11 ({MC_SAMPLE_STEPS} DDIM "
            f"entries): max abs against the unsharded calls {errs[0]:.2e} / {errs[1]:.2e}, K1 "
            f"launches {launches['sharded']} (unsharded {launches['unsharded']}, 16 per UNet "
            f"eval)"), [x.cpu() for x in out["unsharded"]], launches["sharded"]


def cli_sharded_check() -> str:
    """(d) train_zero123.main --model_shards 1 and train_recon.main, two
    steps each inside the process group (the sharded steps), on phase 16's
    and phase 14's data and weights; their whole checkpoints read back into
    one-rank trainers."""
    import torch

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.training import train_recon, train_zero123

    root = os.path.join(SCENES_OUT, "zero123")
    exp = os.path.join(SCENES_OUT, "mc_zero123")
    t0 = time.perf_counter()
    tr = train_zero123.main(["--data_root", os.path.join(root, "views"), "--init_params",
                             os.path.join(root, "init.pt"), "--batch_size", str(TRAIN_BATCH),
                             "--max_steps", "2", "--log_every", "1", "--ckpt_every", "100",
                             "--sample_every", "0", "--model_shards", "1", "--exp_dir", exp])
    z_s = time.perf_counter() - t0
    state = checkpoint.restore(os.path.join(exp, "step_000002"), map_location="cuda")
    for key, module in tr.modules.items():
        module.load_state_dict(state[key], strict=True)
    z_recs = read_metrics(os.path.join(exp, "metrics.jsonl"))
    if tr.step != 2 or tr._grad_sync is None or len(z_recs) != 2:
        fail(f"multicard (d): train_zero123 step {tr.step}, records {z_recs}")
    del tr, state
    exp_r = os.path.join(SCENES_OUT, "mc_recon")
    t0 = time.perf_counter()
    rt = train_recon.main(["--data_root", os.path.join(SCENES_OUT, "data"), "--init_params",
                           os.path.join(SCENES_OUT, "init.pt"), "--num_lods", "2",
                           "--max_steps", "2", "--log_every", "1", "--ckpt_every", "100",
                           "--exp_dir", exp_r])
    r_s = time.perf_counter() - t0
    r_state = checkpoint.restore(os.path.join(exp_r, "step_000002"))
    same = all(torch.equal(r_state["params"][k][n], t.cpu()) for k, m in rt.modules.items()
               for n, t in m.state_dict().items())
    r_recs = read_metrics(os.path.join(exp_r, "metrics.jsonl"))
    if rt.step != 2 or not same or r_state["step"] != 2 or len(r_recs) != 2 \
            or not all(math.isfinite(r["loss"]) for r in r_recs):
        fail(f"multicard (d): train_recon step {rt.step}, checkpoint equal {same}, {r_recs}")
    return (f"(d) inside the group: train_zero123.main --model_shards 1 --max_steps 2 "
            f"({z_s:.1f} s, losses {', '.join(f'{r['loss']:.4f}' for r in z_recs)}, the "
            f"(1, 1) mesh's all-reduced step, checkpoint read back strict); train_recon.main "
            f"--num_lods 2 --max_steps 2 ({r_s:.1f} s, losses "
            f"{', '.join(f'{r['loss']:.4f}' for r in r_recs)}, sharded step, checkpoint equal "
            f"to the trainer)")


def phase_multicard(stage, params, smi):
    """Phase 21: the multi-card paths in a world of one over NCCL.  Returns
    the unsharded stage-1 images phase 22 holds its two ranks to, and the
    K1 / dq / dkv launches of the sharded step and the sharded sampler."""
    from one2345_tpu_torch.core import meshes

    t0 = time.perf_counter()
    with meshes.process_group("cuda:0", rank=0, world_size=1,
                              init_method=f"tcp://localhost:{free_port()}"):
        import torch.distributed as dist

        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"multicard: backend {backend}, expected nccl")
        line_a, launches = zero123_sharded_check(
            stage, params, meshes.create_mesh(("data", "model"), (1, 1)))
        log(f"phase multicard: {line_a} | {smi}")
        data = meshes.create_mesh(("data",))
        log(f"phase multicard: {recon_sharded_check(data)} | {smi}")
        line_c, images, sampler_k1 = sampler_sharded_check(stage, data)
        launches[0] += sampler_k1
        log(f"phase multicard: {line_c} | {smi}")
        log(f"phase multicard: {cli_sharded_check()} | {smi}")
    log(f"phase multicard: world of one over NCCL, {time.perf_counter() - t0:.1f} s in all")
    return images, launches


def gloo_card_rank(rank: int, world: int, port: int, q, draws, steps: int, surface: dict,
                   http_port: int):
    """One of phase 22's gloo ranks on cuda:0: the sharded reconstruction
    step at phase 14's cut config with the world-one draws, then stage 1
    of views 0-3 and 4-11 on a data mesh over both ranks; then phase 24
    (c), ``surface_rank``.  Each part's result goes to ``q`` as (rank,
    part, status, value)."""
    import traceback

    part = "22"
    try:
        sys.path.insert(0, REPO)
        import torch

        from one2345_tpu_torch.core import checkpoint, meshes
        from one2345_tpu_torch.core.config import DiffusionConfig
        from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
        from one2345_tpu_torch.ops.flash_attention import flash_attention as f
        from one2345_tpu_torch.recon.pipeline import ReconStage
        from one2345_tpu_torch.training.recon_trainer import ReconTrainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        meshes.init_process_group("cuda:0", backend="gloo", rank=rank, world_size=world,
                                  init_method=f"tcp://localhost:{port}")
        mesh = meshes.create_mesh(("data",))
        cfg, params, scene = recon_world_one(cut=True)
        tr = ReconTrainer(ReconStage(cfg, params=params, device="cuda:0"), cfg)
        t0 = time.perf_counter()
        m = tr.make_sharded_train_step(mesh)(scene, draws)
        torch.cuda.synchronize()
        recon_s = time.perf_counter() - t0
        # numpy through the queue: a tensor would be shared by a file
        # descriptor that dies with this process
        state = {k: {n: t.detach().cpu().numpy() for n, t in mod.state_dict().items()}
                 for k, mod in tr.modules.items()}
        del tr
        zparams = checkpoint.restore(os.path.join(SCENES_OUT, "zero123", "init.pt"))
        stage = Zero123Stage(DiffusionConfig(), params=zparams, device="cuda:0", mesh=mesh)
        del zparams
        image = input_image(stage.config.image_size)
        f.launch_count = 0
        t0 = time.perf_counter()
        imgs = [stage.stage1(image, 5, indices=idx, steps=steps).cpu().numpy()
                for idx in ([0, 1, 2, 3], list(range(4, 12)))]
        sample_s = time.perf_counter() - t0
        q.put((rank, part, "ok", ({k: float(v) for k, v in m.items()}, state, imgs,
                                  f.launch_count, recon_s, sample_s)))
        del stage, state, imgs
        torch.cuda.empty_cache()
        part = "24c"
        q.put((rank, part, "ok", surface_rank(rank, surface, http_port)))
        meshes.destroy_process_group()
    except BaseException:
        q.put((rank, part, "error", traceback.format_exc()))


def phase_gloo_card(stage, images, smi, surface: dict):
    """Phase 22, and phase 24 (c) in the same world: two gloo ranks on
    cuda:0 (spawned processes): the
    reconstruction data parallelism at phase 14's cut config (both ranks on
    its scene with the world-one draws, so the mean of their gradients and
    statistics is the world-one step's; full width would need two 34 GiB
    steps beside this process) and the sharded stage 1 at full width (each
    rank samples half the views and the all-gather brings them all).  The
    images are held to world-one calls on each rank's own views: a bf16
    UNet at another batch size rounds otherwise, and 25 DDIM entries carry
    that to ~3e-2 (printed against phase 21's whole-batch images).  Then
    each rank runs ``surface_rank``, held to the one-card run of
    ``surface_reference``."""
    import multiprocessing
    import queue as queue_mod

    import torch

    t0 = time.perf_counter()
    reference = surface_reference(surface)
    surface["secs"]["one-card halves reference"] = time.perf_counter() - t0
    ref_m, ref_state, draws, _ = recon_unsharded_step(*recon_world_one(cut=True))
    image = input_image(stage.config.image_size)
    per_rank = [torch.cat([stage.stage1(image, 5, indices=idx[:len(idx) // 2],
                                        steps=MC_SAMPLE_STEPS),
                           stage.stage1(image, 5, indices=idx[len(idx) // 2:],
                                        steps=MC_SAMPLE_STEPS)]).cpu()
                for idx in ([0, 1, 2, 3], list(range(4, 12)))]
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=gloo_card_rank, args=(r, 2, port, q, draws, MC_SAMPLE_STEPS,
                                                      surface, free_port()))
             for r in range(2)]
    for p in procs:
        p.start()
    results, surface_results = {}, {}
    try:
        for _ in range(2 * len(procs)):
            try:
                rank, part, status, value = q.get(timeout=600)
            except queue_mod.Empty:
                fail("gloo card: a rank gave no result in 600 s")
            if status != "ok":
                fail(f"gloo card: rank {rank} failed in phase {part}:\n{value}")
            (results if part == "22" else surface_results)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    lines = []
    for rank in (0, 1):
        m, state, imgs, launches, recon_s, sample_s = results[rank]
        state = {k: {n: torch.from_numpy(t) for n, t in sd.items()} for k, sd in state.items()}
        imgs = [torch.from_numpy(x) for x in imgs]
        recon_line = check_recon_step(f"gloo card rank {rank} (recon)",
                                      recon_step_diff(m, ref_m, state, ref_state, 2e-4))
        errs = [float((a - b).abs().max()) for a, b in zip(imgs, per_rank)]
        whole = [float((a - b).abs().max()) for a, b in zip(imgs, images)]
        if max(errs) > MC_IMG_TOL or launches % 16 or not launches:
            fail(f"gloo card rank {rank}: images max abs {errs} from world one on the ranks' "
                 f"views, K1 {launches}")
        lines.append(f"rank {rank}: recon step {recon_s:.3f} s, {recon_line}; stage 1 "
                     f"{sample_s:.2f} s, images max abs from world one on each rank's views "
                     f"{errs[0]:.2e} / {errs[1]:.2e} (from the whole-batch calls {whole[0]:.2e} "
                     f"/ {whole[1]:.2e}), K1 launches {launches}")
    log(f"phase gloo card: two gloo ranks on cuda:0, {time.perf_counter() - t0:.1f} s with "
        f"their start-up and phase 24 (c): " + "; ".join(lines) + f" | {smi}")
    surface["secs"]["gloo ranks: cli + server"] = max(r["total_s"]
                                                      for r in surface_results.values())
    surface_gloo_check(surface_results, reference, smi)
    return sum(r["cli_k1"] + r["served_k1"] for r in surface_results.values())


def phase_recon_bf16(smi):
    """Phase 23: bf16 reconstruction training.  train_recon.main --dtype
    bfloat16 at phase 14's full width, 4 steps, beside phase 14's f32 run;
    one bf16 scene_loss and its backward at phase 14's cut config against
    its CPU float64 reference, beside the card's f32 errors."""
    import torch

    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training import train_recon
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    exp = os.path.join(SCENES_OUT, "exp_bf16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = train_recon.main(["--data_root", os.path.join(SCENES_OUT, "data"), "--init_params",
                           os.path.join(SCENES_OUT, "init.pt"), "--num_lods", "2", "--dtype",
                           "bfloat16", "--max_steps", "4", "--log_every", "1",
                           "--ckpt_every", "100", "--exp_dir", exp])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = read_metrics(os.path.join(exp, "metrics.jsonl"))
    f32_types = all(t.dtype == torch.float32 for m in tr.modules.values()
                    for t in m.state_dict().values())
    adam = all(v.dtype == torch.float32 for s in tr.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.is_floating_point())
    if tr.step != 4 or [r["step"] for r in recs] != [0, 1, 2, 3] or not f32_types or not adam \
            or not all(math.isfinite(v) for r in recs for v in r.values()):
        fail(f"recon bf16: step {tr.step}, f32 state {f32_types}, f32 Adam {adam}, {recs}")
    secs = [1.0 / r["steps_per_sec"] for r in recs]
    f32 = RECON_F32
    log(f"phase recon bf16: train_recon.main --dtype bfloat16 --num_lods 2 --max_steps 4 at "
        f"full width (33 views at 256^2, 96^3 then 192^3, 512 rays): {total:.2f} s in all, "
        f"seconds per step {', '.join(f'{x:.3f}' for x in secs)} (f32, phase 14: "
        f"{', '.join(f'{x:.3f}' for x in f32['secs'])}, its step 2 with the validation "
        f"renders), loss {', '.join(f'{r['loss']:.4f}' for r in recs)}, peak mem {peak:.2f} GiB "
        f"(f32 {f32['peak']:.2f} GiB); weights, running statistics and Adam state f32 | {smi}")
    del tr
    ref = RECON_REF
    cfg = ref["cfg"].replace(dtype="bfloat16")
    stage = ReconStage(cfg, params=recon_params(seed=30, num_lods=2), device="cuda",
                       f32_weights=True)
    stage.prune_occupancy = lambda volume, mask: ref["mask"].to(volume.device)
    tr = ReconTrainer(stage, cfg)
    loss, metrics = tr.scene_loss(ref["cut"], RECON_TRAIN_STEP, ref["draws"])
    loss.backward()
    grads = {f"{k}.{n}": p.grad.detach().cpu().double() for k, m in tr.modules.items()
             for n, p in m.named_parameters()}
    g64, m64 = ref["g64"], ref["m64"]
    me = {k: abs(float(metrics[k]) - v) / max(abs(v), 1e-30) for k, v in m64.items()}
    norm64 = math.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
    per = {k: float((grads[k] - r).norm()) / max(float(r.norm()), 1e-6 * norm64)
           for k, r in g64.items() if k not in ZERO_GRADS}
    glob = math.sqrt(sum(float(((grads[k] - r) ** 2).sum()) for k, r in g64.items())) / norm64
    if not (math.isfinite(float(loss)) and all(math.isfinite(v) for v in per.values())):
        fail(f"recon bf16: loss {float(loss)}, gradient errors {per}")
    worst = max(per, key=per.get)
    cw = max(ref["card_grads"], key=ref["card_grads"].get)
    log(f"phase recon bf16: one bf16 scene_loss + backward at the cut config (9 views, 48^3 / "
        f"96^3, 64 rays, lod1) against the CPU float64 run: loss {float(loss):.6f} (f64 "
        f"{m64['loss']:.6f}), metrics worst rel {max(me.values()):.2e} ({max(me, key=me.get)}; "
        f"card f32 {max(ref['card_metrics'].values()):.2e}), gradients worst rel L2 "
        f"{per[worst]:.2e} ({worst}; card f32 {ref['card_grads'][cw]:.2e}, {cw}), global "
        f"{glob:.2e} (card f32 {ref['card_global']:.2e}) | {smi}")


# ------------------------------------------------------------ examples
# The gates of the JAX examples' tests (tests/test_pipeline_wiring.py,
# test_recon_quality.py, test_diffusion_quality.py, test_generative_e2e.py),
# as (name, passed) pairs; tests/test_torch_quality_examples_slow.py holds
# the CPU runs to the same lists.
def wiring_gates(ok: dict, flipped: dict, high: dict) -> list:
    return [
        ("psnr_min > 40", ok["psnr_min"] > 40.0),
        ("psnr_query > 40", ok["psnr_query"] > 40.0),
        ("flipped psnr_min < 25", flipped["psnr_min"] < 25.0),
        ("flipped psnr_min < psnr_min", flipped["psnr_min"] < ok["psnr_min"]),
        ("polar 105 psnr_min > 40", high["psnr_min"] > 40.0),
    ]


RECON_QUALITY_CI = dict(steps=300, res=32, vol=16, n_rays=128, n_samples=24, n_importance=24,
                        mesh_resolution=64, seed=0, log_every=100, ft_steps=150)


def recon_quality_gates(out: dict) -> list:
    margin = out["psnr_heldout_masked"] - out["psnr_heldout_masked_random"]
    return [
        ("psnr_last > psnr_first + 10", out["psnr_last"] > out["psnr_first"] + 10.0),
        ("pred_verts > 500", out["pred_verts"] > 500),
        ("0.35 < pred_radius_p10 < 0.55", 0.35 < out["pred_radius_p10"] < 0.55),
        ("chamfer_l1_obs < 0.25", out["chamfer_l1_obs"] < 0.25),
        ("f_score_10_obs > 0.3", out["f_score_10_obs"] > 0.3),
        ("junk_frac < 0.85", out["junk_frac"] < 0.85),
        ("color_mae_bestview < 0.1", out.get("color_mae_bestview", 1.0) < 0.1),
        ("color_mae < 0.35", out.get("color_mae", 1.0) < 0.35),
        ("held-out masked margin > -3 dB", margin > -3.0),
        ("psnr_heldout > 5", out["psnr_heldout"] > 5.0),
        ("ft_color_last < 0.7 ft_color_first", out["ft_color_last"] < 0.7 * out["ft_color_first"]),
        ("ft_pred_verts > 500", out["ft_pred_verts"] > 500),
        ("ft_chamfer_l1_obs < 0.25", out["ft_chamfer_l1_obs"] < 0.25),
        ("ft_f_score_10_obs > 0.3", out["ft_f_score_10_obs"] > 0.3),
        ("ft_color_mae < 0.45", out.get("ft_color_mae", 1.0) < 0.45),
    ]


DIFFUSION_QUALITY_CI = dict(steps=1200, res=32, batch=8, vae_steps=600, sample_steps=8, n_azim=6,
                            model_channels=32, log_every=300, seed=0)


def diffusion_quality_gates(out: dict) -> list:
    return [
        ("vae_psnr > 24", out["vae_psnr"] > 24.0),
        ("eps_mse_last < eps_mse_first / 5", out["eps_mse_last"] < out["eps_mse_first"] / 5.0),
        ("psnr_heldout - psnr_heldout_untrained > 3 dB",
         out["psnr_heldout"] - out["psnr_heldout_untrained"] > 3.0),
        ("pose_margin_db > 1.5", out["pose_margin_db"] > 1.5),
        ("pose_hits >= 2", out["pose_hits"] >= 2),
    ]


GENERATIVE_E2E_CI = dict(size=32, batch=4, diff_steps=12, vae_steps=12, recon_steps=12, n_rays=64,
                         vol=16, sample_steps=4, mesh_resolution=32, model_channels=32,
                         log_every=6, n_samples=16, n_importance=16)


def generative_e2e_gates(out: dict, images, pairs) -> list:
    gates = []
    for label in ("e2e", "e2e_untrained"):
        score = out[label]
        gates += [
            (f"{label} scored", "stage2_psnr_mean" in score and "pred_verts" in score),
            (f"{label} stage2_psnr_mean finite",
             math.isfinite(score.get("stage2_psnr_mean", math.nan))),
        ]
    return gates + [
        ("eps_mse_last finite", math.isfinite(out["eps_mse_last"])),
        ("45 images, 44 pairs", images.shape[0] == 45 and len(pairs) == 44),
        ("conditions: the input view and stage-1 views 1..8",
         {c for c, *_ in pairs} == {0, *range(1, 9)}),
    ]


def check_gates(name: str, gates: list, out: dict):
    failed = [g for g, ok in gates if not ok]
    if failed:
        fail(f"examples: {name} failed its gates {failed}: {json.dumps(out)}")


def example_kernels() -> str:
    """K1, dq and dkv against their plain versions at the examples' shapes."""
    import torch

    lines = []
    for i, (D, T) in enumerate(EXAMPLE_ATTENTION):
        errs = []
        for j, B in enumerate(EXAMPLE_FWD_BATCHES):
            gen = torch.Generator(device="cuda").manual_seed(400 + 10 * i + j)
            q, k, v = (torch.randn(B, T, EXAMPLE_HEADS, D, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            errs.append(check_forward(f"example D={D} T={T} B={B}", q, k, v)[0])
        bwd = []
        for j, B in enumerate(EXAMPLE_BWD_BATCHES):
            case = backward_case(B, T, T, EXAMPLE_HEADS, D, seed=500 + 10 * i + j)
            bwd.append(max(check_backward(f"example D={D} T={T} B={B}", *case)[0]))
        lines.append(f"D={D} T={T}: K1 O err {max(errs):.3e} at B={EXAMPLE_FWD_BATCHES}, "
                     f"dq/dk/dv err {max(bwd):.3e} at B={EXAMPLE_BWD_BATCHES}")
    return "; ".join(lines)


def twins_child(tf32: dict):
    """Phase 19's recon_quality and generative_e2e twins in a process of
    their own, beside the parent's diffusion twin (each is host-bound on
    one core): ({name: (metrics, gates, seconds)}, K1 / dq / dkv launches)."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
    torch.backends.cudnn.allow_tf32 = tf32["cudnn"]
    from examples import torch_generative_e2e as tge
    from examples import torch_recon_quality as trq
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    twins = {}
    t0 = time.perf_counter()
    out = trq.run_benchmark(**RECON_QUALITY_CI, device="cuda")
    twins["recon_quality"] = out, recon_quality_gates(out), time.perf_counter() - t0
    t0 = time.perf_counter()
    out = tge.run_benchmark(**GENERATIVE_E2E_CI, device="cuda")
    images, pairs = tge.build_training_set(75.0, 32, device="cuda")
    twins["generative_e2e"] = (out, generative_e2e_gates(out, images, pairs),
                               time.perf_counter() - t0)
    torch.cuda.synchronize()
    return twins, (flash_attention.launch_count, flash_attention.dq_launch_count,
                   flash_attention.dkv_launch_count)


def examples_in_process(runs: dict):
    """Phase 19's twins in this process: the wiring checks and the
    diffusion twin, with their gates; their seconds go to ``runs``.
    Returns the K1 / dq / dkv launches."""
    from examples import torch_diffusion_quality as tdq
    from examples import torch_pipeline_wiring as tpw
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launch_count = 0
    flash_attention.dq_launch_count = flash_attention.dkv_launch_count = 0
    t0 = time.perf_counter()
    ok = tpw.wiring_check(75.0, 256, device="cuda")
    flipped = tpw.wiring_check(75.0, 256, flip_azimuth=True, device="cuda")
    high = tpw.wiring_check(105.0, 256, device="cuda")
    runs["pipeline_wiring"] = time.perf_counter() - t0
    wiring = {"polar75": ok, "polar75_flipped": flipped, "polar105": high}
    log(f"phase examples: pipeline_wiring tier A metrics {json.dumps(wiring)}")
    check_gates("pipeline_wiring", wiring_gates(ok, flipped, high), wiring)

    t0 = time.perf_counter()
    out = tdq.run_benchmark(**DIFFUSION_QUALITY_CI, device="cuda")
    runs["diffusion_quality"] = time.perf_counter() - t0
    log(f"phase examples: diffusion_quality (bf16) metrics {json.dumps(out)}")
    check_gates("diffusion_quality", diffusion_quality_gates(out), out)
    return (flash_attention.launch_count, flash_attention.dq_launch_count,
            flash_attention.dkv_launch_count)


def phase_examples(estimator, views, smi):
    """The in-env quality examples' torch twins on the card: wiring tier A
    at 256^2, the three trained examples at the JAX tests' CI configs with
    their gates (the diffusion example's tiny stage in bf16; the recon and
    generative twins in a spawned process while this one runs the
    others), the kernels at the examples' shapes, and the match figures
    of phase 7's warm views."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from one2345_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    log(f"phase examples: {smi}: flash kernels at the examples' shapes (H={EXAMPLE_HEADS}, "
        f"against their plain versions, within {O_TOL} / {BWD_TOL}): {example_kernels()}")

    runs = {}
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as child:
        others = child.submit(twins_child, tf32)
        launches = examples_in_process(runs)
        twins, child_launches = others.result()
    for name, (out, gates, secs) in twins.items():
        runs[f"{name} (second process)"] = secs
        log(f"phase examples: {name} metrics {json.dumps(out)}")
        check_gates(name, gates, out)
    launches = tuple(a + b for a, b in zip(launches, child_launches))
    if min(launches) == 0:
        fail(f"examples: a flash kernel was not launched by the examples (K1, dq, dkv: {launches})")

    t0 = time.perf_counter()
    shutil.rmtree(MATCH_OUT, ignore_errors=True)
    try:
        paths = estimator.save_match_visualizations(views, MATCH_OUT)
        shapes = {read_png(p).shape for p in paths}
        names = sorted(os.path.basename(p) for p in paths)
    finally:
        shutil.rmtree(MATCH_OUT, ignore_errors=True)
    want = sorted(f"match_{i}_{j}.png" for i in range(4) for j in range(i + 1, 4))
    H, W = views.shape[1:3]
    if names != want or shapes != {(H, 2 * W + 10, 3)}:
        fail(f"examples: match figures {names} of shapes {shapes}")
    runs["match_figures"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(
        f"phase examples: {len(paths)} match figures ({H}x{2 * W + 10} RGB) written and read "
        f"back | K1 / dq / dkv launches of the examples: {launches[0]} / {launches[1]} / "
        f"{launches[2]} | seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in runs.items())
        + f" | phase {time.perf_counter() - t_phase:.1f} s"
    )



# ------------------------------------------------------------------ surface
# Phase 24: the last of the JAX package's surface on the port, at full width:
# the real-weights runbook on phase 18's reference-format files, the CLI as a
# torchrun world of one loading its kernels from an enable()'d directory, the
# CLI and the HTTP server on two gloo ranks of cuda:0 (in phase 22's world),
# the walkthrough and the demo.
SURFACE_OUT = os.path.join(SCENES_OUT, "surface")


class CountedRuns:
    """Wraps ``One2345Pipeline.run`` while it is entered: each run's
    sampler, quant mode, K1 launches, int8 GEMMs, QConv2d modules and
    seconds go to ``runs``."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        import torch

        from one2345_tpu_torch.diffusion import quantize as q
        from one2345_tpu_torch.ops.flash_attention import flash_attention
        from one2345_tpu_torch.pipeline import runner

        self._run = run = runner.One2345Pipeline.run

        def counted(pipe, *a, **k):
            flash_attention.launch_count = q.int8_matmul.launch_count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(pipe, *a, **k)
            torch.cuda.synchronize()
            d = pipe.config.diffusion
            self.runs.append({
                "sampler": d.sampler, "quant": d.unet.quant, "k1": flash_attention.launch_count,
                "int8": q.int8_matmul.launch_count, "s": time.perf_counter() - t0,
                "qconv": sum(isinstance(m, q.QConv2d) for m in pipe.zero123.unet.modules())})
            return res

        runner.One2345Pipeline.run = counted
        return self

    def __exit__(self, *exc):
        from one2345_tpu_torch.pipeline import runner

        runner.One2345Pipeline.run = self._run
        return False


@contextlib.contextmanager
def torch_tf32_defaults():
    """torch's own TF32 flags for a block (a fresh process has them: the
    torchrun CLI of phase 24 (b) is one), phase_device's after it."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = TORCH_TF32_DEFAULTS["matmul"]
    torch.backends.cudnn.allow_tf32 = TORCH_TF32_DEFAULTS["cudnn"]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def png_difference(a: str, b: str) -> str:
    """Max abs and the count of differing channel values of two PNGs."""
    import numpy as np

    from one2345_tpu_torch.utils.png import read_png

    x, y = read_png(a).astype(int), read_png(b).astype(int)
    if x.shape != y.shape:
        return f"shapes {x.shape} / {y.shape}"
    return f"max abs {np.abs(x - y).max()}, {int((x != y).sum())} of {x.size} values"


def differing_files(a: str, b: str) -> list:
    """The relative paths under ``a`` and ``b`` whose bytes differ or that
    one of them lacks."""
    def walk(root):
        return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
                for d, _, fs in os.walk(root) for f in fs}

    fa, fb = walk(a), walk(b)
    out = sorted(set(fa) ^ set(fb))
    for name in sorted(set(fa) & set(fb)):
        with open(fa[name], "rb") as x, open(fb[name], "rb") as y:
            if x.read() != y.read():
                out.append(name)
    return out


def phase_surface_runbook(ckpt_dir: str, smi) -> dict:
    """Phase 24 (a) and (b).  (a) examples/torch_validate_real_weights.main
    on phase 18's four reference-format files (--skip_download): the
    manifest, the golden DDIM run (4000 K1 launches), the fast-mode A/B
    (1792 each, the int8 GEMMs counted) with "weights": "converted", then
    the same arguments with --dry_run skip the conversion by the manifest.
    (b) the CLI as a torchrun world of one over NCCL with --params the
    converted file and --sampler dpmpp, its kernels loaded from a fresh
    ONE2345_COMPILE_CACHE directory filled with phase 2's libraries (no
    build in it): its artifacts equal the A/B's dpmpp run's, byte for byte.
    Returns what parts (c) and (d) use."""
    import io
    import shutil

    from examples import torch_validate_real_weights as rb
    from one2345_tpu_torch.core import compile_cache
    from one2345_tpu_torch.utils.download_ckpt import CKPTS

    secs = {}
    work = os.path.join(SURFACE_OUT, "runbook")
    img_path, raw = cli_input()  # the phase-11 PNG: > 10 kB, so the runbook reads it
    argv = ["--work", work, "--ckpt_dir", ckpt_dir, "--skip_download", "--img", img_path]
    t0 = time.perf_counter()
    with CountedRuns() as counted, torch_tf32_defaults():
        code = rb.main(argv)
    secs["runbook"] = time.perf_counter() - t0
    params_path = os.path.join(work, "params.pt")
    with open(rb.manifest_path(params_path)) as f:
        manifest = json.load(f)
    with open(os.path.join(work, "fast_mode_ab.json")) as f:
        report = json.load(f)
    if code != 0 or manifest != sorted(CKPTS):
        fail(f"surface (a): the runbook exited {code}, manifest {manifest}")
    if report["weights"] != "converted" or set(report["modes"]) != {"dpmpp", "dpmpp_int8"} or \
            not all(math.isfinite(v) for row in report["modes"].values() for v in row.values()):
        fail(f"surface (a): fast_mode_ab.json {report}")
    runs = counted.runs
    want = [("ddim", "none", 16 * (76 + 49 + 76 + 49)), ("dpmpp", "none", 16 * DPMPP_EVALS),
            ("dpmpp", "int8", 16 * DPMPP_EVALS)]
    if [(r["sampler"], r["quant"], r["k1"]) for r in runs] != want \
            or runs[1]["int8"] or runs[2]["int8"] != runs[2]["qconv"] * DPMPP_EVALS \
            or not runs[2]["qconv"]:
        fail(f"surface (a): the runbook's runs {runs}, expected (sampler, quant, K1) {want} and "
             f"one int8 GEMM per QConv2d and eval")
    stamp = os.stat(params_path).st_mtime_ns
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        again = rb.main(argv + ["--dry_run"])
    secs["runbook again (--dry_run)"] = time.perf_counter() - t0
    if again != 0 or "already covers" not in printed.getvalue() or \
            os.stat(params_path).st_mtime_ns != stamp:
        fail(f"surface (a): the second main did not skip the conversion: {printed.getvalue()!r}")
    shutil.rmtree(ckpt_dir)  # phase 18's reference files: done with
    log("phase surface (a): examples/torch_validate_real_weights.py --skip_download on phase "
        f"18's four reference-format files at torch's TF32 defaults "
        f"({TORCH_TF32_DEFAULTS}): exit 0 in {secs['runbook']:.1f} s (conversion, the "
        "golden run, the eval sweep skipped without the reference's meshes, the A/B); manifest "
        f"{manifest}; runs " + ", ".join(
            f"{r['sampler']}{'+int8' if r['quant'] == 'int8' else ''} {r['s']:.2f} s, K1 {r['k1']}"
            f", int8 GEMMs {r['int8']}" for r in runs)
        + f"; fast_mode_ab.json {json.dumps(report)}; the same arguments with --dry_run skip "
        f"the conversion by the manifest ({secs['runbook again (--dry_run)']:.2f} s) | {smi}")

    # (b) the CLI under torchrun, a world of one, kernels from an enable()'d cache
    cache = os.path.join(PIPELINE_OUT, "compile_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(cache)
    for lib in sorted(compile_cache.build_dir().glob("lib*.so")):
        shutil.copy2(lib, cache)
    before = {n: os.stat(os.path.join(cache, n)).st_mtime_ns for n in os.listdir(cache)}
    built = sorted(os.listdir(compile_cache.build_dir()))
    out_dir = os.path.join(SURFACE_OUT, "torchrun_cli")
    env = dict(os.environ, ONE2345_COMPILE_CACHE=cache)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "localhost", "--master_port", str(free_port()),
           "-m", "one2345_tpu_torch.pipeline.cli", "--img_path", img_path, "--params",
           params_path, "--sampler", "dpmpp", "--out_dir", out_dir, "--seed", "0"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    secs["torchrun cli"] = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    after = {n: os.stat(os.path.join(cache, n)).st_mtime_ns for n in os.listdir(cache)}
    if res.returncode != 0 or f"compile cache: {cache}" not in lines:
        fail(f"surface (b): torchrun cli exited {res.returncode}: {res.stdout[-2000:]} "
             f"{res.stderr[-3000:]}")
    if after != before or sorted(os.listdir(compile_cache.build_dir())) != built:
        fail(f"surface (b): the child built into the cache ({sorted(set(after) - set(before))}) "
             "or the checkout's directory: it should have loaded phase 2's libraries")
    summary = json.loads(next(line for line in reversed(lines) if line.startswith("{")))
    ab_dir = os.path.join(work, "ab", "dpmpp")
    diff = differing_files(out_dir, ab_dir)
    if diff or not any(line.startswith("Mesh saved to:") for line in lines):
        pngs = [d for d in diff if d.endswith(".png")][:3]
        fail(f"surface (b): the torchrun CLI's artifacts differ from the A/B's dpmpp run at "
             f"{len(diff)} files, {diff[:8]}: " + "; ".join(
                 f"{d} {png_difference(os.path.join(out_dir, d), os.path.join(ab_dir, d))}"
                 for d in pngs))
    n_files = sum(len(fs) for _, _, fs in os.walk(out_dir))
    log(f"phase surface (b): python -m torch.distributed.run --nproc_per_node 1 -m "
        f"one2345_tpu_torch.pipeline.cli --params <the runbook's file> --sampler dpmpp: exit 0 "
        f"in {secs['torchrun cli']:.1f} s with its start-up (spans "
        + ", ".join(f"{k} {v:.2f} s" for k, v in summary["timings"].items())
        + f"); loaded its kernels from ONE2345_COMPILE_CACHE={os.path.relpath(cache, REPO)} "
        f"({len(before)} libraries copied from phase 2's build, none built: every file's "
        f"mtime unchanged, nothing added there or to the checkout's directory); its {n_files} "
        f"artifacts equal the A/B's dpmpp run's byte for byte | {smi}")
    shutil.rmtree(cache, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"work": work, "params": params_path, "img": img_path, "raw": raw, "secs": secs}


def halves(sample):
    """``Zero123Stage._sample`` as two ranks of a ``data`` mesh run it: the
    view batch padded to even (the last view repeated), each half sampled
    alone, the halves joined and the pad dropped."""
    import torch

    def run(cond, T, ids, *rest):
        B = cond.shape[0]
        if B % 2:
            cond = torch.cat([cond, cond[-1:]])
            T = torch.cat([T, T[-1:]])
            ids = list(ids) + [ids[-1]]
        h = cond.shape[0] // 2
        return torch.cat([sample(cond[:h], T[:h], ids[:h], *rest),
                          sample(cond[h:], T[h:], ids[h:], *rest)])[:B]

    return run


def surface_rank(rank: int, surface: dict, port: int) -> dict:
    """Phase 24 (c) on one of phase 22's gloo ranks: cli.main --sampler
    dpmpp --params <the runbook's file> in the group (rank 0 writes), then
    the HTTP server over the same weights (server.serve: rank 0 binds
    loopback, rank 1 follows) with one /preprocess, /estimate_elevation
    and /generate_mesh from a client thread, which stops it with SIGINT as
    a user would.  Returns numpy."""
    import base64
    import signal
    import threading
    import urllib.error
    import urllib.request

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.ops.flash_attention import flash_attention as f
    from one2345_tpu_torch.pipeline import cli, server
    from one2345_tpu_torch.pipeline.api import One2345Service
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    t_start = time.perf_counter()
    out_dir = os.path.join(SURFACE_OUT, "gloo_cli", f"rank{rank}")
    f.launch_count = 0
    t0 = time.perf_counter()
    res = cli.main(["--img_path", surface["img"], "--params", surface["params"], "--sampler",
                    "dpmpp", "--out_dir", out_dir, "--seed", "0"], device="cuda:0")
    cli_s, cli_k1 = time.perf_counter() - t0, f.launch_count
    out = {"cli_s": cli_s, "cli_k1": cli_k1, "stage1": res.stage1_images.float().cpu().numpy(),
           "stage2": res.stage2_images.float().cpu().numpy(), "vertices": res.vertices,
           "faces": res.faces, "elevation": res.elevation, "wrote": os.path.isdir(out_dir)}
    del res
    cfg = cli.apply_fast_modes(PipelineConfig(), sampler="dpmpp")
    service = One2345Service(One2345Pipeline(cfg, checkpoint.restore(surface["params"]),
                                             device="cuda:0"))
    f.launch_count = 0
    if rank != 0:
        server.serve(service, device="cuda:0")  # follows rank 0 until it stops
        return dict(out, served_k1=f.launch_count, total_s=time.perf_counter() - t_start)
    with open(surface["img"], "rb") as fh:
        b64 = base64.b64encode(fh.read()).decode()
    answers, times = [], []

    def client():
        base = f"http://127.0.0.1:{port}"
        try:
            for _ in range(600):  # until rank 0 listens
                try:
                    urllib.request.urlopen(base + "/healthz", timeout=5).close()
                    break
                except OSError:
                    time.sleep(0.1)
            for path, payload in (("/preprocess", {"image_b64": b64}),
                                  ("/estimate_elevation", {"seed": 0}),
                                  ("/generate_mesh", {"mesh_resolution": 256, "seed": 0})):
                req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                             method="POST")
                t = time.perf_counter()
                try:
                    with urllib.request.urlopen(req, timeout=600) as r:
                        answers.append((path, r.status, r.read()))
                except urllib.error.HTTPError as e:
                    answers.append((path, e.code, e.read()))
                times.append(time.perf_counter() - t)
        finally:
            os.kill(os.getpid(), signal.SIGINT)  # stops serve_forever, as Ctrl-C does

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    try:
        server.serve(service, port=port, device="cuda:0")
    except KeyboardInterrupt:
        pass
    thread.join(timeout=60)
    return dict(out, served_k1=f.launch_count, answers=answers, request_s=times,
                total_s=time.perf_counter() - t_start)


def surface_reference(surface: dict):
    """The one-card run phase 24 (c)'s two ranks are held to: cli.main's
    config with --sampler dpmpp on the runbook's file and PNG, each sampling
    call in the two halves the ranks sample (``halves``)."""
    import torch

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline
    from one2345_tpu_torch.utils.png import read_png, to_rgba

    pipe = One2345Pipeline(apply_fast_modes(PipelineConfig(), sampler="dpmpp"),
                           checkpoint.restore(surface["params"]), device="cuda:0",
                           auto_mesh=False)
    pipe.zero123._sample = halves(pipe.zero123._sample)
    res = pipe.run(to_rgba(read_png(surface["img"])), seed=0)
    del pipe
    torch.cuda.empty_cache()  # the ranks share the card with this process
    return res


def surface_gloo_check(results: dict, reference, smi):
    """Phase 24 (c) in the parent: each rank's CLI views against the
    one-card halves reference, rank 0's artifacts only, the K1 shares, the
    served mesh read back."""
    import numpy as np

    from one2345_tpu_torch.recon.mesh_extract import load_ply

    lines = []
    ref_s1, ref_s2 = (reference.stage1_images.float().cpu().numpy(),
                      reference.stage2_images.float().cpu().numpy())
    for rank in (0, 1):
        r = results[rank]
        errs = (float(np.abs(r["stage1"] - ref_s1).max()),
                float(np.abs(r["stage2"] - ref_s2).max()))
        same = errs == (0.0, 0.0)
        mesh_same = (np.array_equal(r["vertices"], reference.vertices)
                     and np.array_equal(r["faces"], reference.faces))
        if max(errs) > MC_IMG_TOL or (same and not mesh_same) or \
                r["elevation"] != reference.elevation or r["wrote"] != (rank == 0) or \
                r["cli_k1"] != 16 * DPMPP_EVALS or not r["served_k1"]:
            fail(f"surface (c) rank {rank}: images max abs {errs} from the one-card halves "
                 f"reference, mesh equal {mesh_same}, elevation {r['elevation']} / "
                 f"{reference.elevation}, wrote {r['wrote']}, K1 {r['cli_k1']} / served "
                 f"{r['served_k1']}")
        lines.append(f"rank {rank}: cli.main {r['cli_s']:.1f} s, K1 {r['cli_k1']} (every eval on "
                     f"its half of each batch), stage images max abs {errs[0]:.1e} / "
                     f"{errs[1]:.1e} from one-card calls on the same views, mesh equal "
                     f"{mesh_same}, wrote {r['wrote']}; K1 while serving {r['served_k1']}")
    answers = results[0]["answers"]
    if [(p, s) for p, s, _ in answers] != [("/preprocess", 200), ("/estimate_elevation", 200),
                                           ("/generate_mesh", 200)]:
        fail(f"surface (c): the server answered {[(p, s, b[:300]) for p, s, b in answers]}")
    ply = os.path.join(SURFACE_OUT, "served.ply")
    with open(ply, "wb") as fh:
        fh.write(answers[2][2])
    verts, faces, colors = load_ply(ply)
    check_mesh("surface (c) served", {"vertices": verts, "faces": faces,
                                      "colors": colors.astype(np.float32) / 255.0})
    elevation = json.loads(answers[1][2])["elevation"]
    log("phase surface (c): two gloo ranks on cuda:0 (phase 22's world): " + "; ".join(lines)
        + f" | the server (rank 0 on loopback, rank 1 following): /preprocess, "
        f"/estimate_elevation ({elevation}), /generate_mesh ({len(verts)} vertices, "
        f"{len(faces)} faces read back), "
        + ", ".join(f"{t:.1f}" for t in results[0]["request_s"]) + f" s | {smi}")


def phase_surface_examples(surface: dict, smi):
    """Phase 24 (d): examples/torch_walkthrough.main and
    examples/torch_demo.main on the card with --params the runbook's file
    and its input PNG: 4000 K1 launches each, their artifacts read back."""
    import numpy as np

    from examples import torch_demo, torch_walkthrough
    from one2345_tpu_torch.ops.flash_attention import flash_attention
    from one2345_tpu_torch.recon.mesh_extract import load_ply
    from one2345_tpu_torch.utils.png import read_png

    expected = 16 * (76 + 49 + 76 + 49)
    secs = {}
    walk = os.path.join(SURFACE_OUT, "walkthrough")
    flash_attention.launch_count = 0
    t0 = time.perf_counter()
    summary = torch_walkthrough.main(["--img", surface["img"], "--out", walk, "--params",
                                      surface["params"]])
    secs["walkthrough"] = time.perf_counter() - t0
    k1 = flash_attention.launch_count
    verts, faces, _ = load_ply(os.path.join(walk, "6_mesh.ply"))
    shapes = [read_png(os.path.join(walk, n)).shape for n in torch_walkthrough.ARTIFACTS[:3]]
    if k1 != expected or sorted(os.listdir(walk)) != sorted(torch_walkthrough.ARTIFACTS) or \
            (len(verts), len(faces)) != (summary["mesh_vertices"], summary["mesh_faces"]) or \
            shapes != [(256, 256, 3), (512, 1024, 3), (1024, 2048, 3)] or not len(faces):
        fail(f"surface (d): walkthrough K1 {k1}, files {sorted(os.listdir(walk))}, summary "
             f"{summary}, PNG shapes {shapes}")
    demo = os.path.join(SURFACE_OUT, "demo")
    flash_attention.launch_count = 0
    t0 = time.perf_counter()
    res = torch_demo.main(["--img_path", surface["img"], "--out_dir", demo, "--params",
                           surface["params"]])
    secs["demo"] = time.perf_counter() - t0
    k1 = flash_attention.launch_count
    v, fc, _ = load_ply(os.path.join(demo, "mesh.ply"))
    n_png = sum(name.endswith(".png") for _, _, fs in os.walk(demo) for name in fs)
    if k1 != expected or not np.array_equal(v, res.vertices.astype(np.float32)) or \
            not np.array_equal(fc, res.faces) or n_png != 40 or \
            not os.path.isfile(os.path.join(demo, "pose.json")):
        fail(f"surface (d): demo K1 {k1}, mesh read back equal "
             f"{np.array_equal(fc, res.faces)}, {n_png} PNGs")
    log(f"phase surface (d): examples/torch_walkthrough.py --params (SAM on, DDIM) "
        f"{secs['walkthrough']:.1f} s, K1 {expected}, summary {json.dumps(summary)}, its 5 "
        f"artifacts read back; examples/torch_demo.py --params {secs['demo']:.1f} s, K1 "
        f"{expected}, elevation {res.elevation}, {len(res.vertices)} vertices, mesh.ply, 40 "
        f"PNGs and pose.json read back | seconds of phase 24: "
        + ", ".join(f"{k} {v:.1f}" for k, v in {**surface["secs"], **secs}.items())
        + f" | {smi}")


def main() -> int:
    import shutil

    t_script = time.perf_counter()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "one2345_tpu_torch")):
        print("chip_smoke: one2345_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    smi, exp_rate = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, exp_rate)
    bwd_rows = timed("kernels_bwd", phase_kernels_bwd, exp_rate)
    unet_weights = timed("unet", phase_unet)
    timed("grad", phase_grad)
    stage, params = build_stage(unet_weights)
    _, s2 = timed("sampling", phase_sampling, stage, smi)
    loftr_w, estimator = timed("elevation", phase_elevation, s2[0], smi)
    recon_stage, recon_images, recon_cams, recon_p = timed("recon", phase_recon, s2, smi)
    views = s2[0].clone()
    del s2
    pipeline_mesh = timed("pipeline", phase_pipeline, params, recon_p, loftr_w, smi)
    sam_stage, sam_w, sam_image = timed("preprocess", phase_preprocess, params, smi)
    stages = {"zero123": params, "recon": recon_p, "loftr": loftr_w}
    cli_run_ddim = timed("cli", phase_cli, stages, sam_w, smi)
    launches = cli_run_ddim[2]
    card_int8_unet, cli_run_dpmpp = timed("fast_modes", phase_fast_modes, stage, unet_weights,
                                          stages, sam_w, cli_run_ddim, smi)
    del cli_run_ddim
    _, dq_launches, dkv_launches = timed("train", phase_train, stage, params, smi)
    try:
        recon_trainer, recon_scene = timed("recon_train", phase_recon_train, smi)
        timed("finetune", phase_finetune, recon_p, smi)
        timed("train_zero123", phase_train_zero123, params, smi)
        timed("eval", phase_eval, pipeline_mesh, smi)
        ckpt_dir = timed("convert", phase_convert, stages, sam_w, cli_run_dpmpp, smi)
        del sam_w, cli_run_dpmpp
        surface = timed("surface_runbook", phase_surface_runbook, ckpt_dir, smi)
        world_one_images, sharded_launches = timed("multicard", phase_multicard, stage, params,
                                                   smi)
        sharded_launches[0] += timed("gloo_card", phase_gloo_card, stage, world_one_images, smi,
                                     surface)
        timed("recon_bf16", phase_recon_bf16, smi)
        timed("surface_examples", phase_surface_examples, surface, smi)
    finally:
        shutil.rmtree(SCENES_OUT, ignore_errors=True)
        shutil.rmtree(PIPELINE_OUT, ignore_errors=True)
    log(f"{SCENES_OUT} removed")
    timed("examples", phase_examples, estimator, views, smi)
    timed("device_times", phase_device_times, rows, bwd_rows)
    timed("recon_profile", phase_recon_profile, recon_stage, recon_images, recon_cams, smi)
    timed("elevation_profile", phase_elevation_profile, estimator, views, smi)
    timed("sam_profile", phase_sam_profile, sam_stage, sam_image, smi)
    timed("fast_modes_profile", phase_fast_modes_profile, stage, card_int8_unet, smi)
    timed("recon_train_profile", phase_recon_train_profile, recon_trainer, recon_scene, smi)
    log(f"phase seconds: {json.dumps(PHASE_SECONDS)}; the script "
        f"{time.perf_counter() - t_script:.1f} s")

    def json_bound_by(by: str) -> str:
        # the line names two kinds of bound: the exp unit's rate is a peak
        # rate of operations of one type; `bound_terms` gives all three
        # terms in ms, so an exp bound shows as the largest of them
        return "bytes" if by == "bytes" else "operations"

    head = rows[HEADLINE_SHAPE]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "one2345_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "one2345_tpu/ops/flash_attention.py:36",
        "launches": launches,
        "launches_sharded": sharded_launches[0],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": head["ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": json_bound_by(head["bound_by"]),
        "bound_terms": head["bound_terms"],
        "library_ms": head["library_ms"],
    }]
    for kernel, line, n, n_sh in (("dq", 71, dq_launches, sharded_launches[1]),
                                  ("dkv", 99, dkv_launches, sharded_launches[2])):
        row = bwd_rows[TRAIN_HEADLINE][kernel]
        kernels.append({
            "name": f"flash_attention_bwd_{kernel}",
            "route": "cuda",
            "source": "one2345_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"one2345_tpu/ops/flash_attention.py:{line}",
            "launches": n,
            "launches_sharded": n_sh,
            "max_abs_err": max(r[kernel]["max_abs_err"] for r in bwd_rows.values()),
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": json_bound_by(row["bound_by"]),
            "bound_terms": row["bound_terms"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
