"""Card check of the PyTorch / CUDA port (ptq4vit_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh [--micro-batch N]

``--mesh`` runs phase 11 alone, after what it reads (the build, phases 4
and 5's calibrations, phase 7's first request through the engine), its
mesh calibrations on micro-batches of N images (default 8: 4 a rank, the
single device's micro-batch shape), then the phase's summary as JSON and
the result line; about 3 minutes.

Phases (any failure raises, so the exit code is non-zero):
  1. the card's name and power limit; CUDA is required, TF32 is off;
  2. build the search and serving kernels from ptq4vit_tpu_torch/csrc/
     (one nvcc per source, started together);
  3. each kernel against its plain PyTorch version, with both times (a
     kernel's over at least TIMED_MS of launches), the least time the card
     could take for the same work (for B3 / B3f also the bound of the
     products alone, without the fp32 epilogue) and the share of the int8
     (fp32) peak its operations reach: B1 plain/twin, B2
     signed/post-GELU, B3 a/b/b_sos, B4w fc1 / post-GELU fc2 / qkv n_V=3
     and B4a signed / post-GELU at ViT-B/384 shapes (4 images), B1, B2,
     B4w and B4a also at fc1 with 32 images (the headline job's M =
     18,464) and B3 a / b_sos with 32 images, each B4 case beside
     torch.mm of the same fp32 fake-quant operands P times (cuBLAS SGEMM,
     TF32 off; context only); B3f a/b/b_sos at Swin-B/384 window shapes
     (4 images, stages 1 and 3); B6 in the block's four modes, the head,
     the fp32 engine's qkv and the per-op post-GELU fc2, B7 int8 -> int8 and
     float -> float (SoS and per-head) and B8 at ViT-B/384 shapes with 32
     images (float outputs of B6 bitwise; float attention outputs rtol
     1e-5, atol 2e-5 max|ref|, except in at most 0.05% of the elements,
     each off by at most one probability level's contribution; int8
     outputs one level off in at most 0.1%), beside torch._int_mm (on the
     (K, N) row-major weight and on its K-major layout, cuBLAS's int8
     preference) and SDPA as context; B10 and B11 at Swin-B/384 stages 1
     and 3 and B9 int8
     -> int8 on stage 1's shifted block (64 masks) and stage 4's one
     window, float -> float (SoS and per-head) on stage 1, with 32 images
     (B11 bitwise, B9 and B10 under the same rules), beside torch._int_mm
     (both layouts) and SDPA with the same additive mask; B6's partial
     mode (a row-parallel shard's int32 sums) at the proj and twin fc2
     shapes, bitwise, and q8_epilogue on those sums with a bias and a bf16
     residual (bitwise its plain version and B6's whole-linear output,
     bound by its bytes); the relaxed variants (int8="fused_relaxed") on
     the exact cases' inputs, each against its relaxed plain version with
     the exact kernel timed beside it and the exact case's bound: B6 qkv
     (bf16 requant per column), fc1 (tanh-GELU in bf16, twin pack) and a
     per-op fc1 (GELU, float out), and B10 at stage 1, bitwise their
     relaxed plain versions with the LayerNorm in the kernel's order
     (with PyTorch's, an input that quantizes a level the other way moves
     a relaxed level by up to four: its bf16 chain has coarse steps); B7
     int8 -> int8 SoS and per head, B8 float SoS and B9 int8 -> int8 on
     stage 1's shifted block under the attention rules above; then the
     adversarial relaxed cases (``adversarial_cases``, their reach logged
     by ``adversarial_coverage``: e in the bf16 subnormals and 0, p
     exactly at bf16(split), level products on bf16 ties and on rint's
     half-way points, odd keys and columns, a half-empty pair of rows),
     every output bitwise its relaxed plain version -- their softmax sums
     are exact in any order; each attention
     case's [kernel] line also gives its CUDA-core floor (a model, not a
     measurement: the softmax's instructions a logit at the card's issue
     rate, ``cuda_core_floor``; it stays out of the JSON kernels line);
     each search wrapper's first case again under a scratch bound
     (``scratch_bound``) that cuts its 100 candidates into chunks of
     CHUNK = 37 (3 launches): every sim bitwise the whole call's, both
     timed, the plans of the whole call and of the chunks logged
     (``chunk_cases``); then the large models' shapes
     (``large_kernel_phase``), each under its family's rules: B1 twin and
     B2 post-GELU at ViT-L/384's fc2 (K 4096) and Swin-L/384's stage-4 fc2
     (K 6144), B3 a at ViT-L's 16 heads, B3f b_sos at Swin-L's stage 1 (6
     heads) and b at stage 4 (48 heads), B4w / B4a at Swin-B/384's stage-1
     window rows (4 images); B6 at ViT-L's fc1 / fc2 and Swin-L's stage-1
     fc1 and stage-4 fc2, B7 int8 SoS at 16 heads, B10 / B11 and B9 int8
     SoS at Swin-L's stages 1 and 4 (32 images); each call's plan logged;
     then the 224-px models' shapes (``grid_kernel_phase``), under the
     same rules: B1 / B2 at Swin-T's stage-1 fc1 (K 96) and twin fc2 (K
     384, N 96), B3 a / b / b_sos at window 7 with 3 heads (N = 49, fold
     1), B3f at 4 heads (Swin-B/224 stage 1, fold 4) and at ViT-S/32's 6
     heads of N = 50 (fold 2), 4 images; B6 at Swin-T's stage-1 fc1 / fc2
     and the distilled DeiT-S's head_dist, fc1's relaxed variant, B7 int8
     SoS and its relaxed variant at N = 50 (6 heads), 198 (6) and 197 (3),
     B10 / B11 at res 56, C 96, window 7 (B10 relaxed too), B9 at window 7
     on stage 1's shifted block (3 heads, 64 masks; int8 and float SoS,
     relaxed) and stage 4's clamped window (24 heads), 32 images;
  4. the ViT path: quantize("vit_base_patch16_384", 8 images, PTQ4ViT W8A8)
     with random weights from a seeded generator; B1, B2 and B3 must be
     launched and every interval finite and positive; serve 4 images with
     the fake-quant forward and check the card's forwards against the same
     forwards on the CPU for one image;
  5. the Swin path: the same for "swin_base_patch4_window12_384" at full
     width and depth (149 ops), with B1, B2 and B3f launched;
  6. the exact-scoring path: phase 4 with int8_score=False; B4w and B4a
     are launched 147 times each (49 linears x 3 rounds) and B1-B3f never;
     then the flip count: per op type, the interval slots where this qstate
     and phase 4's int8-scored one differ (same net, images and probe);
  7. the serving paths: phase 4's and phase 5's seeded nets and qstates
     (no second calibration), pack_weights, then ServingEngine (bf16,
     fused kernels) on 4 requests of 32 images each: ViT-B/384 launches B6
     exactly 4 x 49 times and B7 4 x 12, Swin-B/384 B6 4 x 52 and B9, B10
     and B11 4 x 24 each (serve_launches), and no other kernel; finite
     logits; cosine >= 0.99 between the engine's logits and the fused
     fp32 forward's, between the fused fp32 and exact int8=True forwards
     and between int8=True and the fake-quant forward; img/s of the engine
     and of those three forwards; then the relaxed engine
     (ServingEngine(relaxed=True)) on the same requests: each kernel
     launched exactly as serve_launches says (ViT-B/384 a request: B6
     25 exact and 24 relaxed, B7 12 relaxed; Swin-B/384: B6 28 and 24,
     B9 / B10 24 relaxed, B11 24), its img/s (then the exact engine's
     again: exact, relaxed, exact), and its logits against the exact
     engine's: the max and mean shift as a share of max |logit|, top-1
     agreement and the least cosine (>= 0.99); one request's
     device time by kernel under torch.profiler, with the device's busy
     time, the span of its kernels and the wall time;
     after ViT's, B8's path: each block's attention on its captured (B, H,
     N, hd) q, k, v through fused_attention (12 launches), then through
     its relaxed variant (12), each by cosine to the exact int8 attention;
     then the per-op window path: Swin-B/384 at full width, depths (2, 2,
     2, 2), PTQ4ViT W8A8 with no_postgelu calibrated on 8 images (B1, B2,
     B3f), whose fused forward (8 images) launches B6 36 and B9 8 times on
     the float qkv and B10 / B11 never, with finite logits at cosine >=
     0.99 to int8=True;
  8. the policy path, at full ViT-B/384 width and depth 2 built with
     net_from_config: BasePTQ W6A6 (cosine metric: plain torch, no kernel)
     and PTQ4ViT W8A8 sequential (B1, B2 and B3 launched); finite positive
     intervals and finite logits;
  9. the calibration surface, on ViT-B/384 at full width and depth with
     random weights from a seeded generator: an ImageFolder (train/ and
     val/, 2 classes x 24 JPEGs of 500 x 375 and 375 x 500) written to a
     temporary directory; examples/torch_test_vit.py's experiment_basic
     on it (ViTImageNetLoaderGenerator -> calib_batch of 8 -> PTQ4ViT
     W8A8 into a checkpoint directory -> test_classification, 2
     batches), with B1, B2 and B3 launched; whether the native data
     plane ran, and the loader's img/s; the patch-embed conv and blocks
     0-5 calibrated into a fresh checkpoint directory (wrapped_modules),
     then every op on it: only blocks 6-11 and the head are searched, B1
     and B2 launched 75 times and B3 54 (25 linears and 6 + 6 matmuls
     over 3 rounds, search_launches), and the resumed qstate equal to
     experiment_basic's uninterrupted one in every interval slot; W6A6 on the
     same directory searches every op again; minmax_calib (finite
     positive intervals, finite logits) and apply_bias_correction (some
     bias changed, net.params untouched, finite logits), cosines to the
     fp32 logits logged; the raw fp32 net on the val images through the
     float route (EvalTransform(use_native="never")) and the uint8 route
     (raw_uint8 through Evaluator(data_config=)), logits bitwise equal;
  10. the drivers, in process at full width and depth (drivers_phase):
     bench_torch.py on ViT-B/384 (32 images, 2 repeats) and Swin-B/384
     (32 images), B1 / B2 / B3 (B3f) launched exactly as the searches
     need, intervals finite and positive, peak memory below the card's;
     bench_infer_torch.py and scripts/torch_serve_e2e_bench.py on
     ViT-B/384 (B6 / B7 exactly as the fused forwards need; the uint8
     route's logits bitwise the float route's); one cell each of
     examples/torch_test_all.py (BasePTQ W6A6) and
     torch_test_ablation.py (no_softmax, no_postgelu) on 32 synthetic
     images; torch_get_int.py --activations (its npz reread) and
     torch_stability.py (2 seeds, --quick) on phase 9's ImageFolder;
  11. the device mesh (mesh_phase): the exact-scoring ViT-B/384 at depth
     2 on one device, then two ranks (parallel.launch.spawn: gloo on the
     one card, NCCL on cards of their own when there are two) that only
     load the libraries built in phase 2: ViT-B/384 and Swin-B/384
     PTQ4ViT W8A8 calibrated over data=2 on phase 4 / 5's images (4
     images a rank a micro-batch, the single device's micro-batch), and
     the depth-2 ViT under exact scoring; each rank launches exactly the
     kernels the single device's path does, its qstate is the other
     rank's byte for byte, and every slot that differs from phases 4 / 5
     (or the depth-2 run) by more than rtol 1e-5 must be a tie: at the
     first pick where the two runs part, the single device's sims of the
     two picks within 1e-5 (the searches' argmax_trace); ViT-B/384 at
     phase 4's micro-batch over the mesh (2 images a rank) held the same
     way against one device calibrating 2-image micro-batches (the rank's
     shapes), and both against phase 4, the slots that move with the
     capture's micro-batch printed; ServingEngine(mesh=) on
     phase 7's first request of both nets (B6 / B7, B6 / B9-B11, exact
     counts a rank), the gathered logits within rtol 1e-5, atol 1e-5
     max|logit| of phase 7's (elements that differ counted);
     Evaluator(tensor_parallel=True) over model=2 on 8 images: ViT-B/384
     fake-quant by cosine >= 0.99, int8=True and int8="fused" bitwise,
     Swin-B/384 int8="fused" bitwise; fused, each rank launches the single
     device's B6 / B7 (B6 / B9 / B10 / B11) counts -- proj, fc2 and B11 in
     their partial mode -- plus one q8_epilogue a row-parallel linear
     (ViT-B/384 24, Swin-B/384 48); then a one-rank NCCL world:
     ServingEngine(mesh=) bitwise phase 7's and Evaluator(mesh=)'s count
     the single device's; [mesh] lines give the backend, ranks -> devices
     and seconds;
  12. the large models (large_model_phase): ViT-L/384 and Swin-L/384 at
     full width and depth through quantize (PTQ4ViT W8A8, 8 images,
     micro-batch 4), B1 / B2 / B3 (Swin: B3f) launched exactly as their
     inventories need (``model_launches``: ViT-L 291 / 291 / 216: 97
     linears and 24 + 24 matmuls over 3 rounds; Swin-L 300 / 300 / 216),
     served as phase 4 serves, then ServingEngine on 2 requests of 32
     images (``serve_launches``: ViT-L B6 97 and B7 24 a request; Swin-L
     as Swin-B) and the relaxed engine on the first (ViT-L B6 49 exact and
     48 relaxed, B7 24 relaxed), under phase 7's cosine gates; then
     Swin-B/384 under exact scoring (B4w / B4a 300 each, B1-B3f never) and
     the flip count against phase 5's qstate;
  13. the paper's 224-px grid (grid_phase): ViT-S/32, DeiT-T, ViT-B/224,
     the distilled DeiT-S, Swin-T and Swin-B/224 as phase 12 runs its
     models, every launch exact: ViT-S/32 B1 / B2 147 and B3f 108 (its 6
     heads at N = 50 fold by 2, as in JAX), DeiT-T and ViT-B/224 147 /
     147 / 108 on B3, DeiT-S distilled 150 / 150 / 108 (head_dist is
     searched) and B6 50 a request (both heads), Swin-T 156 / 156, B3 18
     (stage 1's 3 heads) and B3f 90, B6 28 and B9-B11 12 a request,
     Swin-B/224 as Swin-B/384;
  14. print the kernels' JSON line (the thirteen kernels and the five
     relaxed variants), the card line, then the result line.
Each path is driven with the launch counts set to 0 just before it and
read just after.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SIMS_RTOL = 1e-4       # reordered fp32 sums of up to ~7M terms
ARGMAX_TIE = 1e-4      # top-two sims closer than this may swap
LEVEL_SHARE = 1e-3     # int8 outputs: at most this share one level off
ATTN_RTOL = 1e-5       # float attention outputs: rtol, atol 2e-5 max|ref|,
FLIP_SHARE = 5e-4      # except in at most this share of the elements, off
                       # by at most one probability level's contribution
NUM_CALIB = 8
TIMED_MS = 100.0       # a kernel's timing spans at least this many ms of
MAX_REPS = 2000        # launches (at most this many)
SERVE_BATCH, SERVE_REQUESTS = 32, 4
SEARCH_SOURCE = "ptq4vit_tpu_torch/csrc/search_kernels.cu"
SERVE_SOURCE = "ptq4vit_tpu_torch/csrc/serve_kernels.cu"
# each kernel: (its source, the TPU kernel it replaces)
KERNELS = {
    "linear_w_hessian_sims_i8": (SEARCH_SOURCE,
                                 "ptq4vit_tpu/ops/pallas_search.py:285"),
    "linear_a_hessian_sims_i8": (SEARCH_SOURCE,
                                 "ptq4vit_tpu/ops/pallas_search.py:453"),
    "matmul_hessian_sims_b3": (SEARCH_SOURCE,
                               "ptq4vit_tpu/ops/pallas_search.py:548"),
    "matmul_hessian_sims_b3f": (SEARCH_SOURCE,
                                "ptq4vit_tpu/ops/pallas_search.py:634"),
    "linear_w_hessian_sims": (SEARCH_SOURCE,
                              "ptq4vit_tpu/ops/pallas_search.py:117"),
    "linear_a_hessian_sims": (SEARCH_SOURCE,
                              "ptq4vit_tpu/ops/pallas_search.py:975"),
    "q8_linear": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:205"),
    "fused_attention_qkv": (SERVE_SOURCE,
                            "ptq4vit_tpu/ops/int8_serve.py:547"),
    "fused_attention": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:486"),
    "fused_window_attention_qkv": (SERVE_SOURCE,
                                   "ptq4vit_tpu/ops/int8_serve.py:638"),
    "q8_win_qkv": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:917"),
    "q8_win_proj": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:974"),
    # B6's epilogue split off for a row-parallel linear under tensor
    # parallelism (JAX: the same Pallas kernel, GSPMD's all-reduce before
    # its epilogue)
    "q8_epilogue": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:205"),
    # the relaxed variants (int8="fused_relaxed"): the same Pallas kernels
    # with relaxed=True, each replacing the body's bf16 branch
    "q8_linear_relaxed": (SERVE_SOURCE,
                          "ptq4vit_tpu/ops/int8_serve.py:141"),
    "fused_attention_qkv_relaxed": (SERVE_SOURCE,
                                    "ptq4vit_tpu/ops/int8_serve.py:343"),
    "fused_attention_relaxed": (SERVE_SOURCE,
                                "ptq4vit_tpu/ops/int8_serve.py:343"),
    "fused_window_attention_qkv_relaxed": (
        SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:343"),
    "q8_win_qkv_relaxed": (SERVE_SOURCE,
                           "ptq4vit_tpu/ops/int8_serve.py:891"),
}
SEARCH = tuple(k for k, (src, _) in KERNELS.items() if src == SEARCH_SOURCE)
# the kernels each path must launch (None: at least once) and must not
EXAMPLE_PATH = "vit_base_patch16_384 examples/torch_test_vit.py"
RESUME_PATH = f"{EXAMPLE_PATH}, resumed from blocks 0-5"
INT8 = ("linear_w_hessian_sims_i8", "linear_a_hessian_sims_i8",
        "matmul_hessian_sims_b3", "matmul_hessian_sims_b3f")
PATHS = {
    "vit_base_patch16_384": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
    "swin_base_patch4_window12_384": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3f": None}, ()),
    "vit_base_patch16_384 exact": (
        {"linear_w_hessian_sims": 147, "linear_a_hessian_sims": 147}, INT8),
    "vit_base_patch16_384 depth 2 BasePTQ W6A6": ({}, SEARCH),
    "vit_base_patch16_384 depth 2 PTQ4ViT sequential": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
    "swin_base_patch4_window12_384 depths (2, 2, 2, 2) no_postgelu": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3f": None}, ()),
    # the calibration surface (phase 9): experiment_basic on an
    # ImageFolder, the part calibrated first, the resumed rest (exact
    # counts set by search_launches), the changed scope, min-max and bias
    # correction
    EXAMPLE_PATH: (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None},
        ("matmul_hessian_sims_b3f", "linear_w_hessian_sims",
         "linear_a_hessian_sims")),
    f"{EXAMPLE_PATH}, blocks 0-5 into a checkpoint": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
    RESUME_PATH: ({}, ()),
    f"{EXAMPLE_PATH}, W6A6 on the same checkpoint": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
    f"{EXAMPLE_PATH}, minmax_calib and apply_bias_correction": ({}, SEARCH),
}
# the drivers (phase 10): the bench scripts in process, one cell of each
# grid, the integer export and the stability study; bench_torch's paths
# are checked exactly by model_launches, its serving ones by
# serve_launches
BENCH_CALIB, BENCH_REPEATS = 32, 2
INFER_ITERS, E2E_BATCHES = 3, 4
BENCH_VIT = (f"vit_base_patch16_384 bench_torch.py, {BENCH_CALIB} images, "
             f"{BENCH_REPEATS} repeats")
BENCH_SWIN = f"swin_base_patch4_window12_384 bench_torch.py, {BENCH_CALIB} images"
INFER_PATH = "vit_base_patch16_384 bench_infer_torch.py"
E2E_PATH = "vit_base_patch16_384 scripts/torch_serve_e2e_bench.py"
TEST_ALL_PATH = ("vit_base_patch16_384 examples/torch_test_all.py, BasePTQ "
                 "W6A6")
ABLATION_PATH = ("vit_base_patch16_384 examples/torch_test_ablation.py, "
                 "no_softmax no_postgelu")
GET_INT_PATH = "vit_base_patch16_384 examples/torch_get_int.py --activations"
STABILITY_PATH = "vit_base_patch16_384 examples/torch_stability.py, 2 seeds"
EXACT = ("linear_w_hessian_sims", "linear_a_hessian_sims")
PATHS.update({
    TEST_ALL_PATH: ({"linear_w_hessian_sims_i8": None,
                     "linear_a_hessian_sims_i8": None},
                    ("matmul_hessian_sims_b3f",) + EXACT),
    ABLATION_PATH: ({"linear_w_hessian_sims_i8": None,
                     "linear_a_hessian_sims_i8": None,
                     "matmul_hessian_sims_b3": None},
                    ("matmul_hessian_sims_b3f",) + EXACT),
    GET_INT_PATH: ({"linear_w_hessian_sims_i8": None,
                    "linear_a_hessian_sims_i8": None,
                    "matmul_hessian_sims_b3": None},
                   ("matmul_hessian_sims_b3f",) + EXACT),
    STABILITY_PATH: ({"linear_w_hessian_sims_i8": None,
                      "linear_a_hessian_sims_i8": None,
                      "matmul_hessian_sims_b3": None},
                     ("matmul_hessian_sims_b3f",) + EXACT),
})
# the /384 models of phases 4-7 and 11; their serving launches a request
# (``serve_launches``): ViT-B/384 B6 49 and B7 12, Swin-B/384 B6 52 and B9,
# B10 and B11 24 each; relaxed, ViT-B/384 B6 25 exact and 24 relaxed, B7 12
# relaxed, Swin-B/384 B6 28 and 24, B9 / B10 24 relaxed, B11 24
BASE = ("vit_base_patch16_384", "swin_base_patch4_window12_384")
# the large models (phase 12) and the paper's 224-px grid (phase 13), each
# calibrated, then served on MODEL_REQUESTS requests through the engine and
# MODEL_RELAXED_REQUESTS through the relaxed one; every launch count
# exact, from the model's op inventory (``search_launches``,
# ``serve_launches``)
LARGE = ("vit_large_patch16_384", "swin_large_patch4_window12_384")
GRID = ("vit_small_patch32_224", "deit_tiny_patch16_224",
        "vit_base_patch16_224", "deit_small_distilled_patch16_224",
        "swin_tiny_patch4_window7_224", "swin_base_patch4_window7_224")
MODEL_REQUESTS, MODEL_RELAXED_REQUESTS = 2, 1
# Swin-B/384 under exact scoring (phase 12): 100 linears x 3 rounds each
SWIN_EXACT_PATH = "swin_base_patch4_window12_384 exact"
PATHS.update({name: ({}, ()) for name in LARGE + GRID})
PATHS[SWIN_EXACT_PATH] = (
    {"linear_w_hessian_sims": 300, "linear_a_hessian_sims": 300}, INT8)
# candidates a chunk in the chunked-versus-whole cases (phase 3): odd, so
# that B3's candidate pairs change places from one chunk to the next
CHUNK = 37
# published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense)
PEAK_OPS = {"int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 5, min_ms: float = TIMED_MS) -> float:
    """Mean ms of a call over at least ``reps`` calls and, for a short
    call, enough calls to fill ``min_ms`` (one warm-up call first, a
    second call sizes the count)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if min_ms > 0:
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        reps = max(reps, min(MAX_REPS, int(min_ms / max(
            e0.elapsed_time(e1), 1e-3)) + 1))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_sims(name, got, ref):
    """Sims within SIMS_RTOL; argmax equal unless a near-tie."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite sims")
    err = (got - ref).abs()
    if not (err <= SIMS_RTOL * ref.abs()).all():
        raise AssertionError(f"{name}: sims off by {float((err / ref.abs()).max()):.3e} relative")
    g2 = got.reshape(got.shape[0], -1)
    r2 = ref.reshape(ref.shape[0], -1)
    for col in range(r2.shape[1]):
        i, j = int(g2[:, col].argmax()), int(r2[:, col].argmax())
        if i != j and abs(float(r2[i, col] - r2[j, col])) > \
                ARGMAX_TIE * abs(float(r2[j, col])):
            raise AssertionError(f"{name}: argmax {i} != {j} (column {col})")
    return float(err.max())


# fp32 operations of B3's / B3f's epilogue per (output, candidate): the
# rescale, the difference and the weighted square, summed (csrc
# mm_epilogue; "b_sos" rescales two sums)
MM_EPILOGUE_OPS = {"a": 5, "b": 5, "b_sos": 8}


def work(kname, args, out, epilogue=True):
    """(operations by type, bytes) a call needs: each input read once and
    the output written once; int8 multiply-adds of the levels (2 ops) for
    B1-B3f, fp32 ones for B4w / B4a and for B3's in-kernel raw = A @ B,
    and (``epilogue``) B3's / B3f's fp32 epilogue."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a)) + out.numel() * out.element_size()
    P = args[3].shape[0] if kname.startswith("matmul") else None
    if kname == "linear_w_hessian_sims_i8":
        (M, K), N, P = args[0].shape, args[4].shape[0], args[5].shape[0]
        return {"int8": 2 * P * M * K * N * (2 if args[1] is not None
                                              else 1)}, nbytes
    if kname == "linear_a_hessian_sims_i8":
        (M, K), N, P = args[0].shape, args[1].shape[0], args[3].shape[0]
        return {"int8": 2 * M * K * N * (P + (1 if args[7] else 0))}, nbytes
    if kname.startswith("matmul"):
        S, G, R, Ci = args[0].shape
        Co = args[1].shape[-1]
        mm = 2 * S * G * R * Ci * Co
        epi = P * S * G * R * Co * MM_EPILOGUE_OPS[args[5]] if epilogue \
            else 0
        return {"int8": P * mm * (2 if args[5] == "b_sos" else 1),
                "fp32": mm + epi}, nbytes
    (M, K), N, P = args[0].shape, args[1].shape[0], args[2].shape[0]
    return {"fp32": 2 * P * M * K * N}, nbytes                 # B4w, B4a


def bound(ops, nbytes):
    """The least time (ms) the card could take, and what bounds it."""
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def peak_share(ops, ms):
    """{type: the share of the card's peak rate of that type} the call's
    operations reach in ``ms``."""
    return {k: n / (ms * 1e-3) / PEAK_OPS[k] for k, n in ops.items()}


def share_text(share):
    return ", ".join(f"{v:.1%} of the {k} peak" for k, v in share.items())


def kernel_phase(sk, dev):
    """Each kernel against its plain version at ViT-B/384 shapes (B3f at
    Swin-B/384's), beside its bound with and without B3's epilogue."""
    from ptq4vit_tpu_torch.quant.fakequant import GELU_NEG_CLIP
    rng = np.random.default_rng(0)
    S, N, d, hid, G, hd, P, q = 4, 577, 768, 3072, 12, 64, 100, 128
    M = S * N
    grid = np.linspace(0.01, 1.2, P + 1)[:P].astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def linear_case(ic, oc, n_V, postgelu):
        x = rng.standard_normal((M, ic)).astype(np.float32)
        if postgelu:
            x = x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
        w = (rng.standard_normal((oc, ic)) * (2 / (ic + oc)) ** 0.5) \
            .astype(np.float32)
        raw = (x @ w.T).astype(np.float32)
        g = (rng.standard_normal((M, oc)) * 1e-4).astype(np.float32)
        return x, w, raw, g

    def case(kname, label, args, ref_name=None, sgemm=None):
        fn = getattr(sk, kname)
        ref = getattr(sk, ref_name or kname + "_ref")
        cases.append((kname, label, args, lambda: fn(*args),
                      lambda: ref(*args), sgemm))

    def sgemm(xq, wq):
        """The P fp32 products of a B4 call alone, as cuBLAS SGEMM runs
        them (TF32 off): context for B4w / B4a, never called by the port."""
        buf = torch.empty(xq.shape[0], wq.shape[0], device=dev)
        return lambda: [torch.mm(xq, wq.t(), out=buf) for _ in range(P)]

    cases = []   # (kernel, label, args, fn, ref_fn, sgemm)
    for label, ic, oc, n_V, pg in (("fc1", d, hid, 1, False),
                                   ("fc2 twin", hid, d, 1, True),
                                   ("qkv n_V=3", d, 3 * d, 3, False)):
        x, w, raw, g = linear_case(ic, oc, n_V, pg)
        a = np.float32((x.max() if pg else np.abs(x).max()) / (q - 0.5))
        a_neg = np.float32(GELU_NEG_CLIP / q)
        lo = 0 if pg else -q
        x_lv = np.clip(np.round(x / a), lo, q - 1)
        x_neg = np.clip(np.round(x / a_neg), -q, 0)
        base = np.abs(w.reshape(n_V, -1)).max(1) / (q - 0.5)
        cw = t(grid[:, None] * base[None].astype(np.float32))
        case("linear_w_hessian_sims_i8", label,
             (t(x_lv, torch.int8), t(x_neg, torch.int8) if pg else None,
              float(a), float(a_neg) if pg else None, t(w), cw, t(raw), t(g),
              q))
        # B4w takes the fake-quant input (twin on fc2) as fp32
        x_sim = x_lv * a + (x_neg * a_neg if pg else 0)
        w_int = (np.abs(w).max() / (q - 0.5)).astype(np.float32)
        w_lv = np.clip(np.round(w / w_int), -q, q - 1)
        products = sgemm(t(x_sim), t(w_lv * w_int))
        case("linear_w_hessian_sims", label,
             (t(x_sim), t(w), cw if n_V > 1 else cw[:, 0].contiguous(),
              t(raw), t(g), q), sgemm=products)
        ca = t(grid * a)
        case("linear_a_hessian_sims_i8", label,
             (t(x), t(w_lv, torch.int8), t(np.full(oc, w_int, np.float32)),
              ca, t(raw), t(g), q, pg, GELU_NEG_CLIP / q if pg else 0.0))
        if n_V == 1:      # B4a: signed (fc1) and post-GELU (fc2)
            case("linear_a_hessian_sims", label,
                 (t(x), t(w_lv * w_int), ca, t(raw), t(g), q, pg,
                  GELU_NEG_CLIP / q if pg else 0.0), sgemm=products)

    # B1, B2, B4w and B4a at fc1 with 32 images, the headline job's shape
    # (a generator of their own keeps the other cases' inputs as they were)
    r32 = np.random.default_rng(7)
    M32 = 32 * N
    x = r32.standard_normal((M32, d)).astype(np.float32)
    w = (r32.standard_normal((hid, d)) * (2 / (d + hid)) ** 0.5) \
        .astype(np.float32)
    raw = (x @ w.T).astype(np.float32)
    g = (r32.standard_normal((M32, hid)) * 1e-4).astype(np.float32)
    a = np.float32(np.abs(x).max() / (q - 0.5))
    base = np.abs(w).max() / (q - 0.5)
    case("linear_w_hessian_sims_i8", "fc1 32 images",
         (t(np.clip(np.round(x / a), -q, q - 1), torch.int8), None,
          float(a), None, t(w), t(grid[:, None] * np.float32(base)),
          t(raw), t(g), q))
    w_int = (np.abs(w).max() / (q - 0.5)).astype(np.float32)
    w_lv = np.clip(np.round(w / w_int), -q, q - 1)
    case("linear_a_hessian_sims_i8", "fc1 32 images",
         (t(x), t(w_lv, torch.int8), t(np.full(hid, w_int, np.float32)),
          t(grid * a), t(raw), t(g), q, False, 0.0))
    x_sim = t(np.clip(np.round(x / a), -q, q - 1) * a)
    products = sgemm(x_sim, t(w_lv * w_int))
    case("linear_w_hessian_sims", "fc1 32 images",
         (x_sim, t(w), t(grid * np.float32(base)), t(raw), t(g), q),
         sgemm=products)
    case("linear_a_hessian_sims", "fc1 32 images",
         (t(x), t(w_lv * w_int), t(grid * a), t(raw), t(g), q, False, 0.0),
         sgemm=products)
    del x, w, raw, g, w_lv, x_sim

    for label, args in matmul_cases(rng, grid, S, G, N, hd, q, t):
        case("matmul_hessian_sims_b3", label, args, "matmul_hessian_sims_ref")
    # Swin-B/384 window matmuls (window 12: N = 144, head dim 32) at 4
    # images: stage 1 (64 windows, 4 heads), stage 3 (4 windows, 16 heads)
    for stage, nwin, G_s in ((1, 64, 4), (3, 4, 16)):
        for label, args in matmul_cases(rng, grid, S * nwin, G_s, 144, 32,
                                        q, t):
            if sk.mm_fold_factor(G_s, args[0].shape[-1],
                                 args[1].shape[-1]) <= 1:
                raise AssertionError("Swin window shapes must fold")
            case("matmul_hessian_sims_b3f", f"stage {stage} {label}", args,
                 "matmul_hessian_sims_ref")
    # B3 at ViT-B/384 with 32 images, the headline job's shape: matmul1 a
    # and matmul2 b_sos (a generator of their own keeps the other cases'
    # inputs as they were)
    for label, args in matmul_cases(np.random.default_rng(8), grid, 32, G,
                                    N, hd, q, t, ("a", "b_sos")):
        case("matmul_hessian_sims_b3", f"{label} 32 images", args,
             "matmul_hessian_sims_ref")

    stats = measure_search(cases)
    chunk_cases(sk, cases, stats, dev)
    return stats


def measure_search(cases):
    """Each search kernel case (kernel, label, args, call, plain call,
    torch.mm x P or None) against its plain version (``check_sims``),
    timed beside it, with its bound and share of the peak; returns the
    stats by kernel, a kernel's first case its headline."""
    stats = {}
    P = 100
    for kname, label, args, fn, ref_fn, products in cases:
        got = fn()
        ref = ref_fn()
        torch.cuda.synchronize()
        err = check_sims(f"{kname} {label}", got, ref)
        del ref
        ms = time_ms(fn, 5)
        plain_ms = time_ms(ref_fn, 1, 0)
        ops, in_bytes = work(kname, args, got)
        bound_ms, bound_by = bound(ops, in_bytes)
        share = peak_share(ops, ms)
        entry = {"case": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "peak_share": share}
        line = (f"[kernel] {kname} {label}: max_abs_err {err:.3e} "
                f"(max |sim| {float(got.abs().max()):.3e}), kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by}), {share_text(share)}")
        if kname.startswith("matmul"):    # the products alone
            pops, _ = work(kname, args, got, epilogue=False)
            entry["products_bound_ms"], _ = bound(pops, in_bytes)
            line += (f", products-only bound "
                     f"{entry['products_bound_ms']:.3f} ms")
        if products is not None:          # B4w / B4a: cuBLAS SGEMM x P
            entry["sgemm_ms"] = time_ms(products, 1, 0)
            line += (f", torch.mm x {P} {entry['sgemm_ms']:.3f} ms (context "
                     "only)")
        log(line)
        s = stats.setdefault(kname, {"max_abs_err": 0.0, "cases": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if "ms" not in s:   # the first case is the entry's headline
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
        s["cases"].append(entry)
    return stats


def matmul_cases(rng, grid, S, G, N, hd, q, t, modes=("a", "b", "b_sos")):
    """matmul1 a / b and matmul2 b_sos inputs (those of ``modes``) at S
    samples, G heads, N tokens, head dim hd (bf16, as the calibration
    caches on the card)."""
    qk = rng.standard_normal((S, G, N, hd)).astype(np.float32)
    kT = rng.standard_normal((S, G, hd, N)).astype(np.float32)
    att = qk @ kT / np.float32(hd ** 0.5)
    att = np.exp(att - att.max(-1, keepdims=True))
    att = (att / att.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((S, G, N, hd)).astype(np.float32)
    g1 = (rng.standard_normal((S, G, N, N)) * 1e-4).astype(np.float32)
    g2 = (rng.standard_normal((S, G, N, hd)) * 1e-4).astype(np.float32)
    bf = torch.bfloat16

    def heads_absmax(a):
        return (np.abs(a).max((0, 2, 3)) / (q - 0.5)).astype(np.float32)

    split = np.float32(2.0 ** -6)
    a_int = np.float32(split / np.float32(q - 1))
    s_hi = np.float32(np.float32(1.0) / np.float32(q - 1))
    out = []
    for label, A, B, gr, mode, cand_src, fix in (
            ("matmul1 a", qk, kT, g1, "a", qk, heads_absmax(kT)),
            ("matmul1 b", qk, kT, g1, "b", kT, heads_absmax(qk)),
            ("matmul2 b_sos", att, v, g2, "b_sos", v,
             np.ones(G, np.float32))):
        if mode not in modes:
            continue
        cm = t(grid[:, None] * heads_absmax(cand_src)[None])
        sos = (float(split), float(a_int), float(s_hi), float(a_int)) \
            if mode == "b_sos" else None
        out.append((label, (t(A, bf), t(B, bf), t(gr, bf), cm, t(fix),
                            mode, q, q, sos)))
    return out


def check_qstate(net, qstate, what):
    if set(qstate) != {n for n, _ in net.op_inventory}:
        raise AssertionError(f"{what}: the qstate does not cover every op")
    for op, qp in qstate.items():
        for f, v in vars(qp).items():
            if torch.is_tensor(v) and not (torch.isfinite(v).all()
                                           and (v > 0).all()):
                raise AssertionError(f"{what}: {op}.{f} is not finite and "
                                     "positive")


def check_launches(path, launches):
    expect, absent = PATHS[path]
    for k, n in expect.items():
        if (launches[k] <= 0) if n is None else (launches[k] != n):
            raise AssertionError(f"{k} was launched {launches[k]} times by "
                                 f"the {path} path, expected "
                                 f"{'some' if n is None else n}")
    for k in absent:
        if launches[k]:
            raise AssertionError(f"{k} was launched by the {path} path")


def check_exact_launches(path, launches, expect):
    """Every kernel launched exactly ``expect``'s count (absent: 0)."""
    for k, v in launches.items():
        if v != expect.get(k, 0):
            raise AssertionError(f"{k} was launched {v} times by the {path} "
                                 f"path, expected {expect.get(k, 0)}")


def run_path(path, sk, net, calib, batch_size=4, **qkw):
    """Quantize ``net`` on ``batch_size``-image micro-batches with the
    launch counts set to 0 just before and read just after; returns
    (qstate, launches, summary)."""
    from ptq4vit_tpu_torch import quantize
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.time()
    net, qstate, report = quantize(net, calib, batch_size=batch_size,
                                   device=torch.device("cuda"),
                                   return_report=True, **qkw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    by_kind = {}
    for op, mtype in net.op_inventory:
        by_kind[mtype] = by_kind.get(mtype, 0.0) + report.search_seconds[op]
    summary = {"path": path, "images": len(calib), "wall_s": wall,
               "capture_s": report.capture_seconds,
               "search_s": sum(report.search_seconds.values()),
               "search_s_by_kind": by_kind,
               "groups": report.num_groups, "peak_gib": peak / 2 ** 30,
               "capture_peak_gib": report.capture_peak_bytes / 2 ** 30,
               "ops": len(qstate), "launches": launches}
    log(f"[calib] {path} x {len(calib)} images: {wall:.1f} s wall, capture "
        f"{summary['capture_s']:.1f} s, search {summary['search_s']:.1f} s, "
        f"groups {report.num_groups}, peak memory {peak / 2**30:.2f} GiB "
        f"({summary['capture_peak_gib']:.2f} GiB by the end of capture), "
        f"{len(qstate)} ops, launches {launches}")
    log(f"[calib] {path} search seconds by op type: "
        + ", ".join(f"{k} {v:.2f}" for k, v in by_kind.items()))
    check_launches(path, launches)
    check_qstate(net, qstate, path)
    return qstate, launches, summary


def serve(path, net, qstate, summary):
    """Serve 4 images with the fake-quant forward; hold the card's forwards
    to the CPU's for one image."""
    from ptq4vit_tpu_torch.utils.convert import params_from_numpy, qstate_to
    size, classes = net.cfg.img_size, net.cfg.num_classes
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 3, size, size)).astype(np.float32)).cuda()
    with torch.no_grad():
        fp = net.apply(x)
        qlog = net.apply(x, qstate=qstate)
    torch.cuda.synchronize()
    if qlog.shape != (4, classes) or not torch.isfinite(qlog).all():
        raise AssertionError("quantized logits are not finite (4, classes)")
    cos = torch.nn.functional.cosine_similarity(qlog, fp, dim=-1)
    summary["serve_cosine"] = [float(c) for c in cos]
    log(f"[serve] {path}, 4 images: cosine(quant, fp32) per image "
        f"{[round(float(c), 5) for c in cos]}")
    if (cos < 0.9).any():
        raise AssertionError("W8A8 logits drifted from the fp32 logits")
    # the card's forwards against the same forwards on the CPU, one image.
    # FP32 logits agree to rounding.  The fake-quant forward of a deep net
    # with random weights is ill-conditioned: a 1e-7 relative input change
    # flips quantization levels that compound to ~3% of the largest logit
    # (measured on the CPU for ViT-B/384), so it is held by cosine instead.
    cpu_params = params_from_numpy(net.params, "cpu")
    with torch.no_grad():
        fp_cpu = net.forward(cpu_params, x[:1].cpu(), net.cfg)
        q_cpu = net.forward(cpu_params, x[:1].cpu(), net.cfg,
                            qstate=qstate_to(qstate, "cpu"))
    fp_diff = float((fp[:1].cpu() - fp_cpu).abs().max())
    q_cos = float(torch.nn.functional.cosine_similarity(
        qlog[:1].cpu(), q_cpu, dim=-1)[0])
    summary.update(cpu_fp32_max_abs_diff=fp_diff, cpu_quant_cosine=q_cos)
    log(f"[serve] {path}, card vs CPU, 1 image: fp32 logits max abs diff "
        f"{fp_diff:.3e} (max |logit| {float(fp_cpu.abs().max()):.3e}); "
        f"fake-quant logits cosine {q_cos:.6f}")
    if fp_diff > 1e-4 * float(fp_cpu.abs().max()):
        raise AssertionError("the card's fp32 forward disagrees with the "
                             "CPU's")
    if q_cos < 0.99:
        raise AssertionError("the card's fake-quant forward disagrees with "
                             "the CPU's")


def calibrate_and_serve(path, name, sk, **qkw):
    """One full-width, full-depth path: quantize ``name`` (random weights
    from a seeded generator, 8 images), check the qstate and serve.
    Returns (qstate on the CPU, launches, summary)."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    net = get_net(name, seed=0)
    size = net.cfg.img_size
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, size, size)).astype(np.float32)
    qkw.setdefault("config", ptq4vit())
    qstate, launches, summary = run_path(path, sk, net, calib, **qkw)
    serve(path, net, qstate, summary)
    qcpu = qstate_to(qstate, "cpu")
    del net, qstate
    torch.cuda.empty_cache()
    return qcpu, launches, summary


def flip_count(inventory, q_int8, q_exact):
    """Per op type [slots where the two qstates' intervals differ, all
    slots]."""
    out = {}
    for op, mtype in inventory:
        a, b = vars(q_int8[op]), vars(q_exact[op])
        for f, v in a.items():
            if torch.is_tensor(v):
                same = torch.isclose(v.reshape(-1), b[f].reshape(-1),
                                     rtol=1e-6, atol=0)
                n = out.setdefault(mtype, [0, 0])
                n[0] += int((~same).sum())
                n[1] += same.numel()
    return out


def policy_phase(sk):
    """BasePTQ W6A6 and PTQ4ViT W8A8 sequential at full ViT-B/384 width,
    depth 2, each with finite positive intervals and finite logits."""
    from ptq4vit_tpu_torch.configs import base_ptq, ptq4vit
    from ptq4vit_tpu_torch.models import model_config, net_from_config, vit
    cfg = dataclasses.replace(model_config("vit_base_patch16_384"), depth=2)
    net = net_from_config(cfg, vit.init_params(
        cfg, np.random.default_rng(0), device="cuda"))
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    x = torch.from_numpy(calib[:4]).cuda()
    out = {}
    for path, qkw in (
            ("vit_base_patch16_384 depth 2 BasePTQ W6A6",
             dict(config=base_ptq(), bits=(6, 6))),
            ("vit_base_patch16_384 depth 2 PTQ4ViT sequential",
             dict(config=ptq4vit(), sequential=True))):
        qstate, launches, summary = run_path(path, sk, net, calib, **qkw)
        with torch.no_grad():
            logits = net.apply(x, qstate=qstate)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{path}: logits are not finite")
        cos = torch.nn.functional.cosine_similarity(
            logits, net.apply(x), dim=-1)
        summary["serve_cosine"] = [float(c) for c in cos]
        log(f"[serve] {path}, 4 images: cosine(quant, fp32) per image "
            f"{[round(float(c), 5) for c in cos]}")
        out[path] = (launches, summary)
    return out


def nbytes(*ts):
    """Bytes of the tensors among ``ts`` (each read or written once)."""
    out = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            out += nbytes(*t)
        elif torch.is_tensor(t):
            out += t.numel() * t.element_size()
    return out


# B6's cases at ViT-B/384 with SERVE_BATCH images (M = 18,464 token
# rows): (label, M, K, N, input mode, LayerNorm, GELU, output, dtype); the
# first is its headline
_M, _D, _HID = SERVE_BATCH * 577, 768, 3072
B6_CASES = (
    ("qkv: LN, quantize -> int8 per column", _M, _D, 3 * _D, "f", True,
     False, "vec", torch.bfloat16),
    ("proj: int8 in -> + residual", _M, _D, _D, "q8", False, False,
     "residual", torch.bfloat16),
    ("fc1: LN, quantize -> GELU -> twin int8", _M, _D, _HID, "f", True, True,
     "twin", torch.bfloat16),
    ("fc2: twin int8 in -> + residual", _M, _HID, _D, "q8twin", False, False,
     "residual", torch.bfloat16),
    ("head: quantize -> float", SERVE_BATCH, _D, 1000, "f", False, False,
     "float", torch.bfloat16),
    ("qkv fp32 engine: LN, quantize -> int8 per column", _M, _D, 3 * _D,
     "f", True, False, "vec", torch.float32),
    ("fc2 per op: post-GELU twin quantize -> float", _M, _HID, _D, "f_twin",
     False, False, "float", torch.float32),
    # a row-parallel shard's int32 partial sums (tensor parallelism), at
    # the single device's shapes
    ("proj partial: int8 in -> int32 sums", _M, _D, _D, "q8", False, False,
     "acc", torch.bfloat16),
    ("fc2 partial: twin int8 in -> int32 pos, neg sums", _M, _HID, _D,
     "q8twin", False, False, "acc", torch.bfloat16))
# q8_epilogue's cases: the summed planes of the proj and fc2 partial cases
# above, + bias + the bf16 residual (B6_CASES labels)
EPILOGUE_CASES = (("proj: one plane + residual",
                   "proj partial: int8 in -> int32 sums"),
                  ("fc2: twin planes + residual",
                   "fc2 partial: twin int8 in -> int32 pos, neg sums"))
# the relaxed variant's B6 cases: a B6_CASES label (its inputs, with
# relaxed=True) or a case of its own, with the exact kernel timed beside
RELAXED_B6 = (("qkv: LN, quantize -> int8 per column", None),
              ("fc1: LN, quantize -> GELU -> twin int8", None),
              ("fc1 per op: quantize -> GELU -> float",
               (_M, _D, _HID, "f", False, True, "float", torch.bfloat16)))
# B10 / B11's Swin-B/384 stages: (stage, resolution, channels)
WINDOW_STAGES = ((1, 96, 128), (3, 24, 512))


def q8_inputs(rng, M, K, N, mode, ln, gelu, out, dtype, q=128,
              dev="cuda"):
    """(args, kwargs) of q8_linear at one of the block's modes, with
    scales that keep the output about unit size."""

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    if mode in ("q8", "q8twin"):
        x = t(rng.integers(-q, q, (M, K)), torch.int8)
        a = 0.03
    else:
        xn = (rng.standard_normal((M, K)) * 2 + 0.3).astype(np.float32)
        if mode == "f_twin":
            xn = np.where(xn > 0, xn, xn * 0.05).astype(np.float32)
        x = t(xn, dtype)
        a = float(np.float32((3.0 if ln else np.abs(xn).max()) / (q - 0.5)))
    twin = mode in ("f_twin", "q8twin")
    kw = dict(a_qmax=q, postgelu=twin, epilogue="gelu" if gelu else None,
              in_q=mode if mode in ("q8", "q8twin") else None,
              out_q={"vec": "vec", "twin": "twin", "acc": "acc"}.get(out),
              out_qmax=q,
              float_dtype=dtype if mode in ("q8", "q8twin") else None)
    if ln:
        kw["ln"] = (t(1 + 0.1 * rng.standard_normal(K)),
                    t(0.1 * rng.standard_normal(K)), 1e-6)
    if out == "residual":
        kw["residual"] = t(rng.standard_normal((M, N)), dtype)
    if out == "vec":
        kw["out_scale"] = t((rng.random(N) + 1.5) / (q - 0.5))
    if out == "twin":
        kw["out_scale"] = (torch.tensor(3.0 / (q - 0.5), device=dev),
                           torch.tensor(0.16997124254703522 / q, device=dev))
    args = (x, t(rng.integers(-q, q, (K, N)), torch.int8),
            t((rng.random(N) + 0.5) / (a * q * q * np.sqrt(K) / 3)),
            None if out == "acc" else t(rng.standard_normal(N) * 0.1),
            torch.tensor(a, device=dev),
            torch.tensor(0.16997124254703522 / q, device=dev) if twin
            else None)
    return args, kw


def kmajor_levels(levels):
    from ptq4vit_tpu_torch.ops.pack import kmajor_levels as kmajor
    return kmajor(levels)


def int_mm_calls(lv, w):
    """torch._int_mm of the (M, K) levels with the (K, N) weight levels,
    row-major and K-major (the (N, K) contiguous copy seen as (K, N),
    cuBLAS's int8 preference): context calls, never the port's."""
    wk = w.t().contiguous().t()
    return {"int_mm_ms": lambda: torch._int_mm(lv, w),
            "int_mm_kmajor_ms": lambda: torch._int_mm(lv, wk)}


def call_bytes(args, kw):
    """Bytes of a call's inputs, the weight levels once (``w_kmaj`` is the
    kernel's copy of ``args[1]``)."""
    return nbytes(args, [v for k, v in kw.items() if k != "w_kmaj"])


def attn_level_step(ph, sos, qmax=128):
    """(H,) the most that one probability level moves an attention output
    of each head: a v level (at most qmax) times b2, times 1 / (qmax - 1)
    (SoS: a level of the upper range; one of the lower range weighs split
    times less) or times a2 (per head)."""
    return qmax * ph[3] * (1.0 / (qmax - 1) if sos else ph[2])


def compare_outputs(name, got, ref, atol=0.0, rtol=0.0, step=None,
                    level_share=LEVEL_SHARE):
    """int8 outputs: at most one level off in at most ``level_share`` of
    the elements (0: bitwise).  Float outputs: |got - ref| <= atol + rtol
    |ref| (0: bitwise) everywhere; with ``step`` (broadcast to the output:
    what one attention probability level moves an element by), at most
    FLIP_SHARE of the elements may be off by up to ``step`` more, where a
    probability rounded to the neighbouring level.  Returns (max abs
    error, share of the elements off by a level or beyond the
    tolerance)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs()
        share = float((d > 0).double().mean())
        if int(d.max()) > 1 or share > level_share:
            raise AssertionError(f"{name}: levels off by up to {int(d.max())}"
                                 f" in {share:.3%} of the outputs")
        return float(d.max()), share
    g, r = got.double(), ref.double()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - r).abs()
    tol = atol + rtol * r.abs()
    share = float((err > tol).double().mean())
    if step is None:
        bad = share > 0.0
    else:
        bad = share > FLIP_SHARE or bool((err > tol + step.double()).any())
    if bad:
        raise AssertionError(f"{name}: {share:.4%} of the outputs off, by "
                             f"up to {float(err.max()):.3e}")
    return float(err.max()), share


def serve_kernel_phase(sv, dev):
    """B6, B7 and B8 against their plain versions at ViT-B/384 shapes with
    32 images (M = 18,464 token rows), beside torch._int_mm on both weight
    layouts (B6) and
    scaled_dot_product_attention (B7, B8) on the same shapes, for context
    only: neither computes the quantized function, and the port never
    calls them."""
    log("[kernel] adversarial relaxed inputs reach: "
        + json.dumps(adversarial_coverage(dev)))
    return measure_serving(serve_kernel_cases(sv, dev)
                           + adversarial_cases(sv, dev))


def serve_kernel_cases(sv, dev):
    """serve_kernel_phase's cases, as measure_serving takes them."""
    rng = np.random.default_rng(5)
    cases, partial, inputs = [], {}, {}
    for label, m, K, Nn, mode, ln, gelu, out, dt in B6_CASES:
        case, args, kw = b6_case(sv, rng, label, m, K, Nn, mode, ln, gelu,
                                 out, dt)
        inputs[label] = (args, kw)
        if out == "acc":
            partial[label] = (args, kw)
        cases.append(case)
    return (cases + epilogue_cases(sv, rng, partial)
            + relaxed_linear_cases(sv, rng, inputs)
            + vit_attention_cases(sv, dev, rng))


def b6_case(sv, rng, label, m, K, Nn, mode, ln, gelu, out, dt):
    """(B6's case as measure_serving takes it, its args, its kwargs) at
    one of the block's modes (``q8_inputs``), the weight K-major as
    pack_weights keeps it, beside torch._int_mm on the same levels."""
    args, kw = q8_inputs(rng, m, K, Nn, mode, ln, gelu, out, dt)
    kw["w_kmaj"] = kmajor_levels(args[1].t())
    twin = mode in ("f_twin", "q8twin")
    # the int8 levels _int_mm would multiply: (M, K) x (K, N)
    lv = args[0] if args[0].dtype == torch.int8 else torch.clamp(
        torch.round(args[0].float() / args[4]), -128, 127).to(torch.int8)
    ops = {"int8": 2 * m * K * Nn * (2 if twin else 1)}
    return ("q8_linear", label,
            lambda: sv.q8_linear(*args, **kw),
            lambda: sv.q8_linear_ref(*args, **kw),
            call_bytes(args, kw), ops, int_mm_calls(lv, args[1]), None,
            None), args, kw


# the relaxed variants held bitwise to their plain versions, the LayerNorm
# computed in the kernel's order (sv.layer_norm_kernel_order)
BITWISE_RELAXED = ("q8_linear_relaxed", "q8_win_qkv_relaxed")


def relaxed_plain(sv, args, kw):
    """The relaxed plain version of a B6 call, its LayerNorm (if any) in
    the kernel's order."""
    x, kw = args[0], dict(kw, relaxed=True)
    if kw.get("ln"):
        x = sv.layer_norm_kernel_order(x, *kw["ln"])
        kw.update(ln=None, float_dtype=kw["float_dtype"] or args[0].dtype)
    return sv.q8_linear_ref(x, *args[1:], **kw)


def relaxed_linear_cases(sv, rng, inputs, specs=RELAXED_B6):
    """B6's relaxed variant (``specs``: RELAXED_B6's form) as
    measure_serving takes them:
    the kernel with relaxed=True against the relaxed plain version
    (``relaxed_plain``), the exact kernel on the same inputs timed beside
    it; the bound is the exact case's (the same work)."""
    cases = []
    for label, spec in specs:
        if spec is None:
            args, kw = inputs[label]
            m, K = args[0].shape
            Nn = args[1].shape[1]
        else:
            m, K, Nn = spec[:3]
            args, kw = q8_inputs(rng, *spec)
            kw["w_kmaj"] = kmajor_levels(args[1].t())
        cases.append((
            "q8_linear_relaxed", f"{label} (relaxed)",
            lambda args=args, kw=kw: sv.q8_linear(*args, relaxed=True, **kw),
            lambda args=args, kw=kw: relaxed_plain(sv, args, kw),
            call_bytes(args, kw), {"int8": 2 * m * K * Nn}, {}, None, None,
            lambda args=args, kw=kw: sv.q8_linear(*args, **kw)))
    return cases


def epilogue_cases(sv, rng, partial):
    """q8_epilogue on the int32 sums of B6's partial cases (``partial``:
    {label: (args, kwargs)}) with a bias and a bf16 residual: first the
    split (partial sums, then q8_epilogue) held bitwise to B6 computing
    the same linear whole, then the cases for measure_serving (the kernel
    against its plain version; bound by its bytes)."""
    cases = []
    for label, key in EPILOGUE_CASES:
        args, kw = partial[key]
        N = args[1].shape[1]
        acc = sv.q8_linear(*args, **kw)
        b = torch.from_numpy(rng.standard_normal(N) * 0.1).float().cuda()
        res = torch.from_numpy(rng.standard_normal(acc.shape[1:])).cuda() \
            .to(torch.bfloat16)
        whole = sv.q8_linear(args[0], args[1], args[2], b, *args[4:],
                             **dict(kw, out_q=None, residual=res))
        ep = (acc, args[2], b, args[4], args[5])
        got = sv.q8_epilogue(*ep, residual=res)
        torch.cuda.synchronize()
        if not torch.equal(got, whole):
            raise AssertionError(f"q8_epilogue {label}: not bitwise B6's "
                                 "whole-linear output")
        log(f"[kernel] q8_epilogue {label}: the partial sums through "
            "q8_epilogue are bitwise B6's whole-linear output")
        cases.append((
            "q8_epilogue", label,
            lambda ep=ep, res=res: sv.q8_epilogue(*ep, residual=res),
            lambda ep=ep, res=res: sv.q8_epilogue_ref(
                *ep, residual=res, out_dtype=res.dtype),
            nbytes(ep, res), {}, {}, None, None))
        del whole, got
    return cases


# CUDA-core instructions a logit of the quantized softmax needs, whatever
# the kernel's design: the function's own steps, one SASS instruction each
# (expf and the IEEE division's fast path 8 each): convert, scale, max,
# subtract, expf, sum, divide (21); then SoS's hi level (2 clamps,
# multiply, rint, 2 clamps, convert: 7) and lo level (2 clamps, divide,
# rint, 2 clamps, convert: 14), or the per-head level (divide, rint, 2
# clamps, convert: 12); a byte packed per level; B9's bias and mask adds 2
SOFTMAX_INSTR = {True: 44, False: 34}
WINDOW_INSTR = 2
# one such instruction a lane a clock: the fp32 peak counts an FMA as two
LANE_RATE = PEAK_OPS["fp32"] / 2


def cuda_core_floor(logits, sos, window=False):
    """The least ms the CUDA cores take for the softmax and the levels of
    ``logits`` logits (SOFTMAX_INSTR at LANE_RATE); the products run
    beside them on the tensor cores."""
    return logits * (SOFTMAX_INSTR[sos] + (WINDOW_INSTR if window else 0)) \
        / LANE_RATE * 1e3


def attention_plain(sv, kname, args, kw):
    """The plain version of a B7 / B8 call (``relaxed`` in kw: the relaxed
    variant's)."""
    relaxed = kw.get("relaxed", False)
    if kname == "fused_attention":
        q_, k_, v_, p1, p2, sc = args
        ph, sos = sv.attn_scope(p1, p2, q_.shape[1])
        return sv.fused_attention_ref(
            q_, k_, v_, ph, p2.split if sos else None, sc, None, sos=sos,
            in_q8=False, qmaxes=sv.attn_qmaxes(p1, p2, 128),
            out_dtype=q_.dtype, relaxed=relaxed)
    x, heads, p1, p2, sc = args
    Bx, Nx, d3 = x.shape
    ph, sos = sv.attn_scope(p1, p2, heads)
    c = x.reshape(Bx, Nx, 3, heads, d3 // 3 // heads) \
        .permute(2, 0, 3, 1, 4)
    out = sv.fused_attention_ref(
        c[0], c[1], c[2], ph, p2.split if sos else None, sc,
        kw.get("out_scale"), sos=sos, in_q8=kw.get("in_q8", False),
        qmaxes=sv.attn_qmaxes(p1, p2, 128),
        out_dtype=x.dtype if x.is_floating_point() else torch.float32,
        relaxed=relaxed)
    return out.transpose(1, 2).reshape(Bx, Nx, d3 // 3)


def vit_attention_cases(sv, dev, rng, H=12, tag="", full=True, N=577,
                        relaxed=None):
    """B7 (int8 -> int8 and float -> float, SoS and per-head) and B8
    (float, SoS) at ViT-B/384 shapes (``H`` heads of 64 and ``N`` tokens:
    ViT-L/384's 16 heads, or the 224-px models' shapes, with ``tag``
    before the labels; ``full`` False: the int8 -> int8 SoS case alone,
    and its relaxed variant with ``relaxed``, which defaults to ``full``)
    with SERVE_BATCH images, as measure_serving takes them, with SDPA on
    the same q, k, v as context."""
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    B, hd = SERVE_BATCH, 64
    relaxed = full if relaxed is None else relaxed
    d = H * hd
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * d))
                           .astype(np.float32)).to(dev)
    t = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(v):
        return (v.abs().amax((0, 2, 3)) / 127.5).reshape(shape)
    qp1 = MatMulQP(A_interval=hmax(t[0]), B_interval=hmax(t[1]))
    split = torch.tensor(2.0 ** -6, device=dev)
    a_out = torch.tensor(0.02, device=dev)
    q4, k4, v4 = (c.contiguous() for c in t)
    cases = []
    for sos in (True, False) if full else (True,):
        qp2 = MatMulQP(A_interval=(split / 127 if sos else
                                   torch.full(shape, 1 / 127.5, device=dev)),
                       B_interval=hmax(t[2]), split=split if sos else None)
        ph, _ = sv.attn_scope(qp1, qp2, H)
        cols = torch.cat([ph[i].repeat_interleave(hd) for i in (0, 1, 3)])
        lv = torch.clamp(torch.round(qkv / cols), -128, 127).to(torch.int8)
        ops = {"int8": 2 * B * H * N * N * hd * (3 if sos else 2),
               # max, subtract, exp, sum, divide per logit
               "fp32": 5 * B * H * N * N}
        floor = cuda_core_floor(B * H * N * N, sos)
        mode = "SoS" if sos else "per-head"
        sdpa = {"sdpa_ms": lambda: torch.nn.functional
                .scaled_dot_product_attention(q4, k4, v4)}
        step = attn_level_step(ph, sos)
        calls = [("fused_attention_qkv", f"{tag}int8 in -> int8 out, {mode}",
                  (lv, H, qp1, qp2, hd ** -0.5),
                  dict(in_q8=True, out_scale=a_out), None),
                 ("fused_attention_qkv", f"float in -> float out, {mode}",
                  (qkv, H, qp1, qp2, hd ** -0.5), {},
                  step.repeat_interleave(hd))][:2 if full else 1]
        if sos and full:
            calls.append(("fused_attention", "(B, H, N, hd) float, SoS",
                          (q4, k4, v4, qp1, qp2, hd ** -0.5), {},
                          step.reshape(1, H, 1, 1)))
        # the relaxed variants: B7 int8 -> int8 (SoS, per head), B8 (SoS)
        calls += [(k + "_relaxed", f"{label} (relaxed)", args,
                   dict(kw, relaxed=True), st)
                  for k, label, args, kw, st in calls
                  if relaxed and (k == "fused_attention" or kw.get("in_q8"))]
        for kname, label, args, kw, st in calls:
            base = kname.replace("_relaxed", "")
            relaxed = kname != base
            cases.append((
                kname, label,
                lambda base=base, args=args, kw=kw: getattr(sv, base)(
                    *args, **kw),
                lambda base=base, args=args, kw=kw: attention_plain(
                    sv, base, args, kw),
                call_bytes(args, kw), ops, {} if relaxed else sdpa, st,
                floor,
                (lambda base=base, args=args, kw=kw: getattr(sv, base)(
                    *args, **dict(kw, relaxed=False))) if relaxed else None))
    return cases


def measure_serving(cases):
    """Each serving kernel case (kernel, label, call, plain call, bytes of
    the inputs, operations, context calls by key, step, CUDA-core floor
    ms or None[, the exact kernel's call: a relaxed variant's case[,
    bitwise: an adversarial case]]) against its plain version
    (``compare_outputs``; attention float outputs under the FLIP_SHARE
    rule, other float outputs bitwise, the relaxed B6 / B10's int8
    outputs too: BITWISE_RELAXED, and every output of a bitwise case),
    then timed
    beside the
    plain version, the exact kernel (``exact_ms``), the bound, the
    attentions' CUDA-core floor (``cuda_core_floor``) and the context
    calls (torch._int_mm on both weight layouts for the linears, SDPA for
    the attentions).  Returns the stats by kernel; a kernel's first case
    is its headline."""
    stats = {}
    for kname, label, fn, plain, in_bytes, ops, lib_fn, step, floor, \
            *rest in cases:
        exact = rest[0] if rest else None
        bitwise = kname in BITWISE_RELAXED or (len(rest) > 1 and rest[1])
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        attention = "attention" in kname
        # attention sums its softmax in another order (but where a case's
        # sums are exact in any order: the adversarial cases)
        tol = (2e-5 * float(ref.float().abs().max()), ATTN_RTOL) \
            if attention and not bitwise else (0.0, 0.0)
        # a relaxed B6 / B10 against the plain version with the kernel's
        # LayerNorm order: bitwise
        err, share = compare_outputs(
            f"{kname} {label}", got, ref, *tol, step=step,
            level_share=0.0 if bitwise else LEVEL_SHARE)
        ms = time_ms(fn, 5)
        plain_ms = time_ms(plain, 1, 0)
        lib = {k: time_ms(f, 5) for k, f in lib_fn.items()}
        if exact is not None:
            lib["exact_ms"] = time_ms(exact, 5)
        bound_ms, bound_by = bound(ops, in_bytes + nbytes(got))
        peak = peak_share(ops, ms)
        entry = {"case": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "peak_share": peak,
                 "out": str(got.dtype).replace("torch.", ""),
                 "max_abs_err": err, "level_flip_share": share, **lib}
        log(f"[kernel] {kname} {label}: {entry['out']} out, max_abs_err "
            f"{err:.3e}" + (" levels" if got.dtype == torch.int8 else "")
            + f" ({share:.4%} of the outputs off by a level or beyond "
            "tolerance)"
            + f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})"
            + (f", CUDA-core floor {floor:.4f} ms" if floor is not None
               else "") + (f", {share_text(peak)}" if peak else "")
            + (", " + ", ".join(f"{k} {v:.3f}" for k, v in lib.items())
               + (" (the exact kernel, then context only)"
                  if exact is not None and len(lib) > 1 else
                  " (the exact kernel)" if exact is not None
                  else " (context only)") if lib else ""))
        st = stats.setdefault(kname, {"max_abs_err": 0.0, "cases": []})
        st["max_abs_err"] = max(st["max_abs_err"], err
                                if got.dtype != torch.int8 else 0.0)
        st["max_share_off"] = max(st.get("max_share_off", 0.0), share)
        if "ms" not in st:
            st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
        st["cases"].append(entry)
        del got, ref
    torch.cuda.empty_cache()
    return stats


def window_linear_inputs(rng, res, C, B=SERVE_BATCH, ws=12, q=128):
    """The positional arguments of B10 (q8_win_qkv: LayerNorm, quantize,
    int8 per column) and of B11 (q8_win_proj: int8 in, residual) at one
    Swin stage (``res`` x ``res`` tokens of C channels an image, windows of
    ``ws``), bf16 activations, with scales that keep the outputs about
    unit size."""
    dev = "cuda"

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    bf = torch.bfloat16
    x4 = t(rng.standard_normal((B, res, res, C)) * 2 + 0.3, bf)
    a = torch.tensor(3.0 / (q - 0.5), device=dev)
    w = t(rng.integers(-q, q, (C, 3 * C)), torch.int8)
    wsc = t((rng.random(3 * C) + 0.5) / (float(a) * q * q * np.sqrt(C) / 3))
    qkv = (x4, w, wsc, t(rng.standard_normal(3 * C) * 0.1), a,
           (t(1 + 0.1 * rng.standard_normal(C)),
            t(0.1 * rng.standard_normal(C)), 1e-5), ws,
           t((rng.random(3 * C) + 1.5) / (q - 0.5)))
    N = ws * ws
    y_q = t(rng.integers(-q, q, (B * res * res // N, N, C)), torch.int8)
    wp = t(rng.integers(-q, q, (C, C)), torch.int8)
    proj = (y_q, wp, t((rng.random(C) + 0.5) / (0.03 * q * q * np.sqrt(C)
                                                / 3)),
            t(rng.standard_normal(C) * 0.1), torch.tensor(0.03, device=dev),
            ws, res, t(rng.standard_normal((B, res, res, C)), bf))
    return qkv, proj


# B9's Swin-B/384 cases: (stage, resolution, heads, shift, modes)
WINDOW_ATTN_STAGES = ((1, 96, 4, 6, ("int8 SoS", "float SoS",
                                     "float per-head")),
                      (4, 12, 32, 0, ("int8 SoS",)))


def window_attention_cases(sv, dev, rng, stages=WINDOW_ATTN_STAGES, tag="",
                           relaxed=True, ws=12):
    """B9 int8 -> int8 on Swin-B/384 stage 1's shifted block (64 masks) and
    stage 4's one unshifted window (32 heads), and float -> float (SoS and
    per-head) on stage 1's shifted block (or the ``stages`` given, with
    ``tag`` before the labels), with SERVE_BATCH images (window 12: N =
    144 tokens, head dim 32), as measure_serving takes them, with SDPA on
    the float q, k, v and the same additive bias and mask as context; with
    ``relaxed``, the relaxed variant on stage 1's int8 SoS inputs; ``ws``:
    the window (7 at the 224-px models: N = 49)."""
    from ptq4vit_tpu_torch.models.swin import shifted_window_mask
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    B, hd, q = SERVE_BATCH, 32, 128
    N = ws * ws

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    def levels(x, a):
        return torch.clamp(torch.round(x.float() / a), -q, q - 1) \
            .to(torch.int8)

    cases = []
    for stage, res, H, shift, modes in stages:
        C = H * hd
        nW = (res // ws) ** 2
        B_ = B * nW
        qkv = t(rng.standard_normal((B_, N, 3 * C)))
        bias = t(rng.standard_normal((H, N, N)) * 0.5)
        mask = shifted_window_mask(res, ws, shift)
        mask = t(mask) if mask is not None else None
        tq = qkv.reshape(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q4, k4, v4 = (c.contiguous() for c in tq)
        extra = bias[None] + (mask[:, None] if mask is not None else 0)
        sdpa_mask = extra.repeat(B, 1, 1, 1)
        shape = (1, H, 1, 1, 1, 1, 1)

        def hmax(v):
            return (v.abs().amax((0, 2, 3)) / 127.5).reshape(shape)
        s = hd ** -0.5
        qp1 = MatMulQP(A_interval=hmax(tq[0] * s), B_interval=hmax(tq[1]))
        split = torch.tensor(2.0 ** -6, device=dev)
        for mode in modes:
            sos = mode.endswith("SoS")
            qp2 = MatMulQP(A_interval=(split / 127 if sos else
                                       torch.full(shape, 1 / 127.5,
                                                  device=dev)),
                           B_interval=hmax(tq[2]),
                           split=split if sos else None)
            ph, _ = sv.window_attn_scope(qp1, qp2, H, s)
            if mode.startswith("int8"):
                cols = torch.cat([ph[i].repeat_interleave(hd)
                                  for i in (0, 1, 3)])
                x, kw = levels(qkv / cols, 1.0), dict(
                    in_q8=True, out_scale=torch.tensor(0.02, device=dev))
                label, step = f"{mode}, int8 -> int8", None
            else:
                x, kw, label = qkv, {}, f"{mode}, float -> float"
                step = attn_level_step(ph, sos).repeat_interleave(hd)
            where = f"shifted, {nW} masks" if shift else "one window"
            label = f"{tag}stage {stage}, {where}: {label}"
            args = (x, H, nW, qp1, qp2, s, bias, mask)
            ref_args = (x, H, nW, ph, split if sos else None, s, bias, mask,
                        kw.get("out_scale"))
            ref_kw = dict(sos=sos, in_q8=mode.startswith("int8"),
                          qmaxes=(q,) * 5, out_dtype=torch.float32)
            ops = {"int8": 2 * B_ * H * N * N * hd * (3 if sos else 2),
                   # the bias and mask adds, max, subtract, exp, sum, divide
                   "fp32": 7 * B_ * H * N * N}
            floor = cuda_core_floor(B_ * H * N * N, sos, window=True)
            cases.append((
                "fused_window_attention_qkv", label,
                lambda args=args, kw=kw: sv.fused_window_attention_qkv(
                    *args, **kw),
                lambda a=ref_args, kw=ref_kw: sv.fused_window_attention_ref(
                    *a, **kw), nbytes(args), ops,
                {"sdpa_ms": lambda qkv4=(q4, k4, v4), m=sdpa_mask: torch.nn
                 .functional.scaled_dot_product_attention(
                     *qkv4, attn_mask=m)}, step, floor))
            if relaxed and stage == 1 and mode == "int8 SoS":
                # the relaxed variant on the same inputs
                cases.append((
                    "fused_window_attention_qkv_relaxed", f"{label} (relaxed)",
                    lambda args=args, kw=kw: sv.fused_window_attention_qkv(
                        *args, relaxed=True, **kw),
                    lambda a=ref_args, kw=ref_kw:
                    sv.fused_window_attention_ref(*a, relaxed=True, **kw),
                    nbytes(args), ops, {}, step, floor,
                    lambda args=args, kw=kw: sv.fused_window_attention_qkv(
                        *args, **kw)))

    return cases


# ---------------------------------------------------------------------------
# adversarial relaxed cases: inputs built to reach the edges of the relaxed
# bf16 chain, each case held bitwise to its relaxed plain version
# ---------------------------------------------------------------------------

ADV_SPLIT_FLOOR = 2.0 ** -7    # the split is a p value at least this large


def adversarial_attention_inputs(dev, N=145, hd=64, seed=11, window=False):
    """(qkv int8 levels (B, N, 3 H hd), qp1, qp2 for SoS, qp2 per head,
    a_out, scale) of a relaxed B7 / B9 call whose logits fall in three
    classes a row: near the row max (d = l - max in [-4.2, 0], so e >=
    2^-6), far (d in [-97.4, -83.6]: e from 2^-120 down through the bf16
    subnormals, below 2^-126, to 0) and gone (d < -300: e = 0).  q's
    levels are (127, r, 0, ...) with r in [-3, 3], k's (127 - D, c, 0,
    ...) with D 0, 64-68 or 255 and c in [-64, 64], at a logit scale
    (a1 b1) s of about 0.0108.  So every fp32 sum of a row's e is exact in
    any order -- the near e are multiples of 2^-13 summing below 2^8, the
    far ones sum below half an ulp of them -- and the kernel, which sums
    in another order than the plain version, must agree with it bitwise.
    N odd: the last pair of keys is half empty.  The SoS split is a p
    value of the inputs (p exactly at bf16(split)); the per-head scale
    a2 = 1/96 and a_out = 1/96 make the level products p * 96 (10
    significant bits) round on bf16 ties and land on rint's half-way
    points.  ``window``: for B9, whose q scale is a1 / s (qp1's
    A_interval holds a1 s, so the logit scale is the same)."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    rng = np.random.default_rng(seed)
    B, H = 8, 4
    d = H * hd
    q = np.zeros((B, N, H, hd), np.int64)
    k = np.zeros((B, N, H, hd), np.int64)
    q[..., 0] = 127
    q[..., 1] = rng.integers(-3, 4, (B, N, H))
    cls = rng.choice(3, size=(B, N, H), p=[0.35, 0.45, 0.2])
    cls[:, 0] = 0                       # a near key in every row
    k[..., 0] = 127 - np.where(cls == 0, 0, np.where(
        cls == 1, rng.integers(64, 69, (B, N, H)), 255))
    k[..., 1] = rng.integers(-64, 65, (B, N, H))
    v = rng.integers(-128, 128, (B, N, H, hd))
    qkv = torch.from_numpy(np.stack([q, k, v], 2).reshape(B, N, 3 * d)
                           .astype(np.int8)).to(dev)
    shape = (1, H, 1, 1, 1, 1, 1)

    def full(x):
        return torch.full(shape, x, device=dev)
    scale = 0.125
    qp1 = MatMulQP(A_interval=full(0.25 * scale if window else 0.25),
                   B_interval=full(0.3456))
    a_out = torch.tensor(1.0 / 96, device=dev)
    per_head = MatMulQP(A_interval=full(1.0 / 96), B_interval=full(0.01))
    # p of the plain version's chain, for the split
    t = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    ph, _ = (sv.window_attn_scope(qp1, per_head, H, scale) if window
             else sv.attn_scope(qp1, per_head, H))
    e = adversarial_e(t[0], t[1], ph, scale)
    p = sv.bf(e * sv.rcp_bf(e.sum(-1, keepdim=True)))
    cand = p[p >= ADV_SPLIT_FLOOR]
    split = cand.sort().values[cand.numel() // 2].reshape(())
    sos = MatMulQP(A_interval=split / 127, B_interval=full(0.01),
                   split=split)
    return qkv, qp1, sos, per_head, a_out, scale


def adversarial_e(q, k, ph, scale, extra=None):
    """e = bf16(exp(bf16(l - max))) of the relaxed plain version's chain
    (sv.fused_attention_ref) on (B, H, N, hd) int8 q, k levels."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops.int8 import int_dot
    H = q.shape[1]
    a1, b1 = (ph[i].float().reshape(1, H, 1, 1) for i in range(2))
    logits = int_dot(q, k.transpose(-2, -1)) * (
        a1 * b1 * torch.tensor(scale, dtype=torch.float32, device=q.device))
    if extra is not None:
        logits = logits + extra
    m = torch.amax(logits, -1, keepdim=True)
    return sv.bf(torch.exp(sv.bf(logits - m)))


def bf16_ties(x):
    """How many float32 values of x lie half-way between two bf16 values
    (the low 16 bits exactly 0x8000)."""
    return int(((x.float().contiguous().view(torch.int32) & 0xFFFF)
                == 0x8000).sum())


def adversarial_coverage(dev):
    """What the adversarial attention inputs reach in the relaxed plain
    version's chain: e in the bf16 subnormals, e = 0, p exactly at
    bf16(split), bf16 ties in the level products (SoS lower levels, per
    head) and rint's half-way points (per head).  Every count must be
    positive for the inputs to test these edges."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    qkv, qp1, sos, per_head, a_out, scale = adversarial_attention_inputs(dev)
    B, N, d3 = qkv.shape
    H = qp1.A_interval.shape[1]
    t = qkv.reshape(B, N, 3, H, d3 // 3 // H).permute(2, 0, 3, 1, 4)
    ph, _ = sv.attn_scope(qp1, sos, H)
    e = adversarial_e(t[0], t[1], ph, scale)
    p = sv.bf(e * sv.rcp_bf(e.sum(-1, keepdim=True)))
    spb = sv.bf(sos.split)
    a_int = sv.fq.exact_div(sos.split, torch.tensor(127.0, device=dev))
    lo = torch.clamp(p, torch.zeros_like(spb), spb) * sv.rcp_bf(a_int)
    head = p * sv.rcp_bf(per_head.A_interval.reshape(-1)[0])
    return {"e_subnormal": int(((e > 0) & (e < 2.0 ** -126)).sum()),
            "e_zero": int((e == 0).sum()),
            "p_at_split": int((p == spb).sum()),
            "lower_level_ties": bf16_ties(lo),
            "per_head_ties": bf16_ties(head),
            "per_head_rint_halves": int((sv.bf(head) % 1 == 0.5).sum())}


def adversarial_linear_inputs(dev, gelu, out, ln):
    """(args, kw) of a relaxed B6 call at ragged shapes -- M = 65 (the
    last row tile one row: the kernel's last pair of rows half empty), N
    = 151 (odd columns) -- whose first 8 weight columns are 0, so those
    outputs are their bias exactly: values that round on a bf16 tie (1 +
    2^-8, -(3 + 2^-6)), tiny ones whose tanh-GELU chain runs through bf16
    and fp32 subnormals (1e-13, -3e-14, 2^-130) and 0; every other column
    requantizes at 1/96 (a reciprocal of 96: products on bf16 ties)."""
    M, K, N = 65, 200, 151
    args, kw = q8_inputs(np.random.default_rng(12), M, K, N, "f", ln, gelu,
                         out, torch.bfloat16, dev=dev)
    args = list(args)
    w, b = args[1].clone(), args[3].clone()
    w[:, :8] = 0
    b[:8] = torch.tensor([1 + 2.0 ** -8, -(3 + 2.0 ** -6), 1e-13, -3e-14,
                          2.0 ** -130, 0.0, 2.0 ** -126, -0.5 - 2.0 ** -9],
                         device=dev)
    args[1], args[3] = w, b
    if out == "vec":
        kw["out_scale"] = torch.full((N,), 1.0 / 96, device=dev)
    return tuple(args), kw


def adversarial_cases(sv, dev):
    """The adversarial relaxed cases as measure_serving takes them, each
    bitwise against its relaxed plain version and timed beside its exact
    kernel: B7 int8 in, SoS int8 and float out, per-head int8 out; B9 on
    one window of 11 x 11 (N = 121, odd: the parked path); B6 with
    LayerNorm -> int8 per column, GELU -> twin, GELU -> float."""
    qkv, qp1, sos, per_head, a_out, scale = adversarial_attention_inputs(dev)
    B, N, d3 = qkv.shape
    H = qp1.A_interval.shape[1]
    hd = d3 // 3 // H
    cases = []

    def attn(label, qp2, out_scale):
        kw = dict(in_q8=True, out_scale=out_scale)
        args = (qkv, H, qp1, qp2, scale)
        sos_ = qp2.split is not None
        ops = {"int8": 2 * B * H * N * N * hd * (3 if sos_ else 2),
               "fp32": 5 * B * H * N * N}
        return ("fused_attention_qkv_relaxed", f"adversarial: {label}",
                lambda: sv.fused_attention_qkv(*args, relaxed=True, **kw),
                lambda: attention_plain(sv, "fused_attention_qkv", args,
                                        dict(kw, relaxed=True)),
                call_bytes(args, kw), ops, {}, None, None,
                lambda: sv.fused_attention_qkv(*args, **kw), True)
    cases.append(attn("N = 145, SoS, int8 out", sos, a_out))
    cases.append(attn("N = 145, SoS, float out", sos, None))
    cases.append(attn("N = 145, per head, int8 out", per_head, a_out))
    # B9: one 11 x 11 window an image (nW = 1), zero bias, no mask
    wq = adversarial_attention_inputs(dev, N=121, hd=32, seed=13,
                                      window=True)
    wqkv, wqp1, wsos = wq[0], wq[1], wq[2]
    s = wq[5]
    Hw = wqp1.A_interval.shape[1]
    bias = torch.zeros((Hw, 121, 121), device=dev)
    wargs = (wqkv, Hw, 1, wqp1, wsos, s, bias, None)
    wkw = dict(in_q8=True, out_scale=a_out)
    ph, _ = sv.window_attn_scope(wqp1, wsos, Hw, s)
    cases.append((
        "fused_window_attention_qkv_relaxed",
        "adversarial: one 11 x 11 window (N = 121, parked), SoS, int8 out",
        lambda: sv.fused_window_attention_qkv(*wargs, relaxed=True, **wkw),
        lambda: sv.fused_window_attention_ref(
            wqkv, Hw, 1, ph, wsos.split, s, bias, None, a_out, sos=True,
            in_q8=True, qmaxes=(128,) * 5, out_dtype=torch.float32,
            relaxed=True),
        nbytes(wargs), {"int8": 2 * wqkv.shape[0] * Hw * 121 * 121 * 32 * 3},
        {}, None, None,
        lambda: sv.fused_window_attention_qkv(*wargs, **wkw), True))
    for gelu, out, ln in ((False, "vec", True), (True, "twin", True),
                          (True, "float", False)):
        args, kw = adversarial_linear_inputs(dev, gelu, out, ln)
        M, K = args[0].shape
        Nn = args[1].shape[1]
        cases.append((
            "q8_linear_relaxed",
            f"adversarial: M = {M}, N = {Nn}, "
            + ("LN, " if ln else "") + ("GELU -> " if gelu else "-> ")
            + out, lambda args=args, kw=kw: sv.q8_linear(
                *args, relaxed=True, **kw),
            lambda args=args, kw=kw: relaxed_plain(sv, args, kw),
            call_bytes(args, kw), {"int8": 2 * M * K * Nn}, {}, None, None,
            lambda args=args, kw=kw: sv.q8_linear(*args, **kw), True))
    return cases


def win_qkv_relaxed_plain(sv, args, kw):
    """B10's relaxed plain version on its window-partitioned rows, the
    LayerNorm in the kernel's order."""
    from ptq4vit_tpu_torch.models.swin import window_partition
    x4, w, wsc, b, a, ln, ws, osc = args
    xw = window_partition(x4, ws)
    out = sv.q8_linear_ref(
        sv.layer_norm_kernel_order(xw.reshape(-1, x4.shape[-1]), *ln), w,
        wsc, b, a, None, a_qmax=kw["a_qmax"], postgelu=False, out_q="vec",
        out_scale=osc, out_qmax=kw["out_qmax"], relaxed=True)
    return out.reshape(xw.shape[:-1] + (w.shape[1],))


def window_kernel_phase(sv, dev):
    """B10, B9 and B11 against their plain versions at Swin-B/384 shapes
    with 32 images (window 12: N = 144 tokens, head dim 32), beside
    torch._int_mm on the same levels, both weight layouts (B10, B11), and
    SDPA with the same additive bias and mask on the float q, k, v (B9),
    for context only.
    B10 and B11 at stage 1 (res 96, C 128, 64 windows an image) and stage
    3 (res 24, C 512); B9 int8 -> int8 on stage 1's shifted block (64
    masks) and stage 4's one unshifted window (32 heads), and float ->
    float (SoS and per-head) on stage 1's shifted block."""
    return measure_serving(window_kernel_cases(sv, dev))


def window_kernel_cases(sv, dev, stages=WINDOW_STAGES,
                        attn_stages=WINDOW_ATTN_STAGES, tag="", relaxed=True,
                        seed=6, ws=12):
    """window_kernel_phase's cases, as measure_serving takes them (or at
    the ``stages`` and ``attn_stages`` given in windows of ``ws``, with
    ``tag`` before the labels and, without ``relaxed``, no relaxed
    variant)."""
    rng = np.random.default_rng(seed)
    B, q = SERVE_BATCH, 128

    def levels(x, a):
        return torch.clamp(torch.round(x.float() / a), -q, q - 1) \
            .to(torch.int8)

    cases = []        # as measure_serving takes them
    for stage, res, C in stages:
        M = B * res * res
        args, proj_args = window_linear_inputs(rng, res, C, ws=ws)
        x4, w, a = args[0], args[1], args[4]
        lv = levels(x4.reshape(M, C), a)
        kw = dict(a_qmax=q, out_qmax=q, w_kmaj=kmajor_levels(w.t()))
        cases.append(("q8_win_qkv", f"{tag}stage {stage}: LN, quantize -> "
                      "int8 per column",
                      lambda args=args, kw=kw: sv.q8_win_qkv(*args, **kw),
                      lambda args=args, kw=kw: sv.q8_win_qkv_ref(
                          *args, **kw), nbytes(args),
                      {"int8": 2 * M * C * 3 * C}, int_mm_calls(lv, w),
                      None, None))
        if relaxed and stage == 1:
            # the relaxed variant on the same inputs
            cases.append((
                "q8_win_qkv_relaxed", f"{tag}stage {stage}: LN, quantize -> "
                "int8 per column (relaxed)",
                lambda args=args, kw=kw: sv.q8_win_qkv(*args, relaxed=True,
                                                       **kw),
                lambda args=args, kw=kw: win_qkv_relaxed_plain(sv, args, kw),
                nbytes(args),
                {"int8": 2 * M * C * 3 * C}, {}, None, None,
                lambda args=args, kw=kw: sv.q8_win_qkv(*args, **kw)))
        args = proj_args
        y_q, wp = args[0], args[1]
        kw = dict(a_qmax=q, w_kmaj=kmajor_levels(wp.t()))
        cases.append(("q8_win_proj", f"{tag}stage {stage}: int8 in -> + "
                      "residual (image layout)",
                      lambda args=args, kw=kw: sv.q8_win_proj(*args, **kw),
                      lambda args=args, kw=kw: sv.q8_win_proj_ref(*args,
                                                                  **kw),
                      nbytes(args), {"int8": 2 * M * C * C},
                      int_mm_calls(y_q.reshape(M, C), wp), None, None))

    return cases + window_attention_cases(sv, dev, rng, attn_stages, tag,
                                          relaxed, ws)


def profile_call(fn):
    """One call of ``fn`` under torch.profiler: device time by kernel (ms,
    launches), the busy time of the device, the span from the first
    kernel's start to the last one's end, and the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_kernel, t_lo, t_hi = {}, float("inf"), 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
        name = name.split("(")[0].strip()[:60]
        ms, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        t_lo = min(t_lo, e.time_range.start)
        t_hi = max(t_hi, e.time_range.end)
    busy = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    return {"busy_ms": busy, "span_ms": (t_hi - t_lo) / 1e3,
            "wall_ms": wall * 1e3,
            "by_kernel": [[k, ms, n] for k, (ms, n) in top]}


def serving_phase(sk, sv, name, qcpu, requests=SERVE_REQUESTS,
                  relaxed_requests=SERVE_REQUESTS):
    """The serving path of ``name``: the calibration phase's seeded net and
    its qstate (no second calibration), pack_weights, then ServingEngine
    (bf16) on ``requests`` requests of SERVE_BATCH images with the
    launch counts set to 0 just before and read just after, each kernel
    launched exactly as ``serve_launches`` says, then
    the relaxed engine on the first ``relaxed_requests``; then the fused
    fp32, exact int8 and fake-quant forwards on the first request, held to
    each other and the engine's logits to the fused fp32 ones by cosine
    (>= 0.99), and the img/s of each.  Returns (launches, summary, (net,
    qstate, the first request on the card))."""
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.ops.pack import pack_weights
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    path = f"{name} serving"
    net = get_net(name, seed=0)
    qstate = qstate_to(qcpu, "cuda")
    size, classes = net.cfg.img_size, net.cfg.num_classes
    reqs = [np.random.default_rng(10 + i).standard_normal(
        (SERVE_BATCH, 3, size, size)).astype(np.float32)
        for i in range(requests)]
    torch.cuda.synchronize()
    t0 = time.time()
    packed = pack_weights(net.params, qstate)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    engine = ServingEngine(net, qstate)                 # bf16, the card
    engine(reqs[0])                                     # warm-up
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    sv.reset_launch_counts()
    t0 = time.time()
    outs = [engine(x) for x in reqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**sk.launch_counts(), **sv.launch_counts()}
    check_exact_launches(path, launches, {
        k: requests * n for k, n in serve_launches(name).items()})
    for o in outs:
        if o.shape != (SERVE_BATCH, classes) or not torch.isfinite(
                o.float()).all():
            raise AssertionError("served logits are not finite "
                                 f"({SERVE_BATCH}, {classes})")
    n_img = SERVE_BATCH * requests
    x0 = torch.from_numpy(reqs[0]).cuda()
    ips = {"fused bf16 engine": n_img / wall}
    relaxed = relaxed_serving(sk, sv, name, net, qstate,
                              reqs[:relaxed_requests],
                              outs[:relaxed_requests])
    ips["relaxed bf16 engine"] = relaxed["img_per_s"]
    # the exact engine again, so the two alternate (exact, relaxed, exact)
    t0 = time.time()
    for x in reqs:
        engine(x)
    torch.cuda.synchronize()
    ips["fused bf16 engine, again"] = n_img / (time.time() - t0)
    logits = {}
    with torch.no_grad():
        for name, fwd in (
                ("fused fp32", lambda: net.apply(x0, qstate=qstate,
                                                 int8="fused",
                                                 packed=packed)),
                ("exact int8", lambda: net.apply(x0, qstate=qstate,
                                                 int8=True, packed=packed)),
                ("fake-quant", lambda: net.apply(x0, qstate=qstate))):
            logits[name] = fwd()                        # warm-up
            torch.cuda.synchronize()
            t0 = time.time()
            logits[name] = fwd()
            torch.cuda.synchronize()
            ips[name] = SERVE_BATCH / (time.time() - t0)
    cos = {}
    for a, b in (("fused fp32", "exact int8"), ("exact int8", "fake-quant"),
                 ("fused fp32", "fused bf16 engine")):
        la = logits[a] if a in logits else outs[0]
        lb = logits[b] if b in logits else outs[0]
        c = torch.nn.functional.cosine_similarity(la.float(), lb.float(),
                                                  dim=-1)
        cos[f"{a} vs {b}"] = float(c.min())
    summary = {"path": path, "requests": requests,
               "batch": SERVE_BATCH, "wall_s": wall, "pack_s": pack_s,
               "img_per_s": ips, "min_cosine": cos, "launches": launches,
               "relaxed": relaxed,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[serve] {path}: {requests} requests x {SERVE_BATCH} images "
        f"in {wall:.3f} s, pack_weights {pack_s:.3f} s, launches {launches}")
    log(f"[serve] img/s at {SERVE_BATCH} images: " + ", ".join(
        f"{k} {v:.1f}" for k, v in ips.items()))
    log("[serve] min cosine over the request's images: " + ", ".join(
        f"{k} {v:.6f}" for k, v in cos.items()))
    for k, c in cos.items():
        if c < 0.99:
            raise AssertionError(f"{k}: cosine {c:.4f} < 0.99")
    # where one request's time goes on the device
    prof = profile_call(lambda: engine(reqs[0]))
    summary["profile"] = prof
    log(f"[profile] {path}, one request of {SERVE_BATCH} images under "
        f"torch.profiler: device busy {prof['busy_ms']:.2f} ms of a "
        f"{prof['span_ms']:.2f} ms span and {prof['wall_ms']:.2f} ms wall; "
        "by kernel (ms, launches): " + ", ".join(
            f"{k} {ms:.2f} x{n}" for k, ms, n in prof["by_kernel"][:10]))
    first = outs[0].cpu()
    del engine, packed, outs, logits
    torch.cuda.empty_cache()
    return launches, summary, (net, qstate, x0, first)


RELAXED_COSINE = 0.99   # the relaxed engine's logits to the exact one's


def relaxed_serving(sk, sv, name, net, qstate, reqs, exact):
    """The relaxed engine (ServingEngine(relaxed=True), bf16) on the same
    requests as the exact engine, whose logits are ``exact``: the launch
    counts set to 0 just before its requests and read just after, each
    kernel launched exactly as ``serve_launches(name, True)`` says;
    finite logits; its
    img/s; the logits against the exact engine's: the max shift as a
    share of max |logit|, top-1 agreement, and the least cosine (at least
    RELAXED_COSINE).  Returns the summary, its path and launches
    included."""
    from ptq4vit_tpu_torch import ServingEngine
    path = f"{name} serving, relaxed"
    engine = ServingEngine(net, qstate, relaxed=True)
    engine(reqs[0])                                     # warm-up
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    sv.reset_launch_counts()
    t0 = time.time()
    outs = [engine(x) for x in reqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**sk.launch_counts(), **sv.launch_counts()}
    check_exact_launches(path, launches, {
        k: len(reqs) * n for k, n in serve_launches(name, True).items()})
    r = torch.cat([o.float() for o in outs])
    e = torch.cat([o.float() for o in exact])
    if r.shape != e.shape or not torch.isfinite(r).all():
        raise AssertionError(f"{path}: logits not finite {tuple(e.shape)}")
    out = {"path": path, "launches": launches, "wall_s": wall,
           "img_per_s": r.shape[0] / wall,
           "max_shift": float((r - e).abs().max() / e.abs().max()),
           "mean_shift": float((r - e).abs().mean() / e.abs().max()),
           "top1_agree": float((r.argmax(-1) == e.argmax(-1)).double()
                               .mean()),
           "min_cosine": float(torch.nn.functional.cosine_similarity(
               r, e, dim=-1).min())}
    log(f"[serve] {path}: {len(reqs)} requests x {SERVE_BATCH} images "
        f"in {wall:.3f} s ({out['img_per_s']:.1f} img/s), launches "
        f"{launches}; against the exact engine: max shift "
        f"{out['max_shift']:.4f} of max |logit|, mean {out['mean_shift']:.5f}"
        f", top-1 agreement {out['top1_agree']:.4f}, min cosine "
        f"{out['min_cosine']:.6f}")
    if out["min_cosine"] < RELAXED_COSINE:
        raise AssertionError(f"{path}: cosine {out['min_cosine']:.4f} to "
                             f"the exact engine < {RELAXED_COSINE}")
    del engine, outs
    return out


def layout_path(sk, sv, net, qstate, x):
    """B8's path: every block's attention of the calibrated ViT-B/384 on
    its (B, H, N, hd) q, k, v (from a capture of 4 images) through
    ``fused_attention``, then through its relaxed variant
    (``relaxed=True``), each with the launch counts set to 0 just before
    and read just after; each context held by cosine to the exact int8
    path (matmul_int8 -> softmax -> matmul_int8).  Returns {path:
    launches} and the summaries."""
    from ptq4vit_tpu_torch.models.common import softmax_f32
    from ptq4vit_tpu_torch.ops.int8 import matmul_int8
    base = "vit_base_patch16_384 attention, (B, H, N, hd) layout"
    scale = net.cfg.head_dim ** -0.5
    depth = net.cfg.depth
    with torch.no_grad():
        _, taps = net.apply(x, capture=True)
    qkv = []
    for i in range(depth):
        m1 = taps[f"blocks.{i}.attn.matmul1"]
        m2 = taps[f"blocks.{i}.attn.matmul2"]
        qkv.append((m1["a"].contiguous(),
                    m1["b"].transpose(-2, -1).contiguous(),
                    m2["b"].contiguous(), qstate[f"blocks.{i}.attn.matmul1"],
                    qstate[f"blocks.{i}.attn.matmul2"]))
    del taps
    with torch.no_grad():
        refs = [matmul_int8(softmax_f32(matmul_int8(
            q, k.transpose(-2, -1), qp1) * scale), v, qp2)
            for q, k, v, qp1, qp2 in qkv]
    by_path, summaries = {}, []
    for relaxed in (False, True):
        path = base + (", relaxed" if relaxed else "")
        kernel = "fused_attention_relaxed" if relaxed else "fused_attention"
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        sv.reset_launch_counts()
        t0 = time.time()
        outs = [sv.fused_attention(q, k, v, qp1, qp2, scale,
                                   relaxed=relaxed)
                for q, k, v, qp1, qp2 in qkv]
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {**sk.launch_counts(), **sv.launch_counts()}
        check_exact_launches(path, launches, {kernel: depth})
        cos = min(float(torch.nn.functional.cosine_similarity(
            o.reshape(-1).double(), r.reshape(-1).double(), dim=0))
            for o, r in zip(outs, refs))
        log(f"[serve] {path}: {depth} blocks x {len(x)} images in "
            f"{wall:.4f} s, min cosine to the exact int8 attention "
            f"{cos:.6f}, launches {launches}")
        if cos < 0.99:
            raise AssertionError(f"{path}: cosine {cos:.4f} < 0.99")
        by_path[path] = launches
        summaries.append({"path": path, "images": len(x), "wall_s": wall,
                          "min_cosine": cos, "launches": launches})
    return by_path, summaries


def window_per_op_path(sk, sv):
    """The per-op window path: Swin-B/384 at full width, depths cut to (2,
    2, 2, 2), calibrated with PTQ4ViT W8A8 and no_postgelu (8 images), so
    fc2 is a plain linear and no block is in scope of the fused block
    path.  Its fused forward on 8 images, with the launch counts set to 0
    just before and read just after, runs each block's four linears, the
    3 reductions and the head through B6 (4 x 8 + 4 = 36) and each
    block's attention through B9 on the float qkv (8), with no B10 or
    B11; finite logits, cosine >= 0.99 to the exact int8=True forward."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import model_config, net_from_config, swin
    from ptq4vit_tpu_torch.ops.pack import pack_weights
    cfg = dataclasses.replace(model_config("swin_base_patch4_window12_384"),
                              depths=(2, 2, 2, 2))
    net = net_from_config(cfg, swin.init_params(
        cfg, np.random.default_rng(0), device="cuda"))
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    path = "swin_base_patch4_window12_384 depths (2, 2, 2, 2) no_postgelu"
    qstate, calib_launches, summary = run_path(
        path, sk, net, calib, config=ptq4vit(no_postgelu=True))
    x = torch.from_numpy(calib).cuda()
    packed = pack_weights(net.params, qstate)
    with torch.no_grad():
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        sv.reset_launch_counts()
        t0 = time.time()
        fused = net.apply(x, qstate=qstate, int8="fused", packed=packed)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {**sk.launch_counts(), **sv.launch_counts()}
        exact = net.apply(x, qstate=qstate, int8=True, packed=packed)
    blocks = sum(cfg.depths)
    expect = {"q8_linear": 4 * blocks + cfg.num_layers,
              "fused_window_attention_qkv": blocks}
    for k, v in launches.items():
        if v != expect.get(k, 0):
            raise AssertionError(f"{k} was launched {v} times by the {path} "
                                 f"forward, expected {expect.get(k, 0)}")
    if not torch.isfinite(fused).all():
        raise AssertionError(f"{path}: logits are not finite")
    cos = float(torch.nn.functional.cosine_similarity(
        fused.double(), exact.double(), dim=-1).min())
    summary.update(forward_s=wall, forward_launches=launches,
                   min_cosine_to_exact=cos)
    log(f"[serve] {path}: fused per-op forward of {len(x)} images in "
        f"{wall:.3f} s, launches {launches}, min cosine to int8=True "
        f"{cos:.6f}")
    if cos < 0.99:
        raise AssertionError(f"{path}: cosine {cos:.4f} < 0.99")
    del net, qstate, packed
    torch.cuda.empty_cache()
    # the calibration's launches and the forward's, apart
    return {path: calib_launches, f"{path} serving": launches}, summary


def write_image_folder(root, per_class=24):
    """An ImageFolder of JPEGs: train/ and val/, 2 classes x ``per_class``
    images each, landscape (500 x 375) and portrait (375 x 500) in turn,
    smooth colour fields plus noise from a seeded generator."""
    from PIL import Image
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:500, 0:500] / 500.0
    for split in ("train", "val"):
        for cls in ("n01440764", "n01443537"):
            d = os.path.join(root, split, cls)
            os.makedirs(d)
            for i in range(per_class):
                w, h = (500, 375) if i % 2 else (375, 500)
                c = rng.random((3, 3))
                img = np.stack([c[k, 0] * xx[:h, :w] + c[k, 1] * yy[:h, :w]
                                + c[k, 2] for k in range(3)], -1) * 160
                img = img + rng.normal(0, 12, (h, w, 3))
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    os.path.join(d, f"{split}_{i:03d}.jpg"), quality=90)


def search_launches(cfg, inventory, shapes, ops=None):
    """B1 / B2 / B3 / B3f launches that searching ``ops`` (every op of
    ``inventory`` when None) takes under int8 scoring: each linear
    launches B1 and B2 once a round; each attention matmul twice a round
    (its A side, then its B side), except the SoS matmul, whose split
    search is plain PyTorch (B side only) -- on B3f where the head fold of
    its shape (``shapes``, ``mm_fold_factor``) is above 1, as the JAX
    function picks its folded body there, else on B3.  One Swin-T/S
    calibration so launches both: B3 at stage 1's 3 heads, B3f at the
    stages past it."""
    from ptq4vit_tpu_torch.ops.search_kernels import mm_fold_factor
    n = dict.fromkeys(INT8, 0)
    for op, mtype in inventory:
        if ops is not None and op not in ops:
            continue
        pol = cfg.op_policy(mtype)
        if "qmatmul" in mtype:
            info = shapes[op]
            fold = mm_fold_factor(info["heads"], info["inner"], info["cols"])
            n["matmul_hessian_sims_b3f" if fold > 1
              else "matmul_hessian_sims_b3"] += pol.search_round * (
                1 if pol.quantizer == "sos_matmul" else 2)
        elif mtype != "qconv":
            n["linear_w_hessian_sims_i8"] += pol.search_round
            n["linear_a_hessian_sims_i8"] += pol.search_round
    return n


def model_launches(name):
    """``search_launches`` of every op of the zoo model ``name`` under
    PTQ4ViT W8A8."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    inv, shapes = model_ops(name)
    return search_launches(ptq4vit(), inv, shapes)


def serve_launches(name, relaxed=False):
    """Launches of the serving kernels that one request of the zoo model
    ``name`` makes through the fused engine (every other kernel: 0).
    ViT / DeiT: B6 for qkv, proj, fc1 and fc2 of each block and for the
    head (and the distilled head), B7 in each block.  Swin: each block
    runs B10 (qkv), B9 and B11 (proj), and B6 for fc1 and fc2; B6 also for
    each patch-merging reduction and the head.  ``relaxed``: qkv (B10),
    fc1 and the attention run the relaxed variants; proj, fc2, B11, the
    reductions and the heads (float outputs without GELU, the same
    function) the exact kernels -- B6 as many a request in all."""
    from ptq4vit_tpu_torch.models import model_config, swin
    cfg = model_config(name)
    if isinstance(cfg, swin.SwinConfig):
        blocks, tail = sum(cfg.depths), cfg.num_layers
        if relaxed:
            return {"q8_linear": blocks + tail, "q8_linear_relaxed": blocks,
                    "fused_window_attention_qkv_relaxed": blocks,
                    "q8_win_qkv_relaxed": blocks, "q8_win_proj": blocks}
        return {"q8_linear": 2 * blocks + tail,
                "fused_window_attention_qkv": blocks, "q8_win_qkv": blocks,
                "q8_win_proj": blocks}
    heads = 2 if cfg.distilled else 1
    if relaxed:
        return {"q8_linear": 2 * cfg.depth + heads,
                "q8_linear_relaxed": 2 * cfg.depth,
                "fused_attention_qkv_relaxed": cfg.depth}
    return {"q8_linear": 4 * cfg.depth + heads,
            "fused_attention_qkv": cfg.depth}


def slot_diff(a, b):
    """[(op, field, flat slot, a value, b value)] where two qstates differ."""
    out = []
    for op, qp in a.items():
        for f, v in vars(qp).items():
            if torch.is_tensor(v):
                w = getattr(b[op], f)
                for i in torch.nonzero((v != w).reshape(-1)).reshape(-1):
                    out.append((op, f, int(i), float(v.reshape(-1)[i]),
                                float(w.reshape(-1)[i])))
    return out


def calibrate_counted(path, sk, net, calib, cfg, **kw):
    """One HessianQuantCalibrator run with the launch counts set to 0 just
    before and read just after; returns (qstate, report, launches, s)."""
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    t0 = time.time()
    c = HessianQuantCalibrator(net, cfg, calib, batch_size=4, **kw)
    qstate = c.batching_quant_calib()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = sk.launch_counts()
    log(f"[calib] {path}: {wall:.2f} s wall, {len(c.report.search_seconds)} "
        f"ops searched in {sum(c.report.search_seconds.values()):.2f} s, "
        f"{len(qstate)} in the qstate, launches {launches}")
    check_launches(path, launches)
    return qstate, c.report, launches, wall


def calibration_surface_phase(sk, sv, root):
    """Phase 9, the calibration surface on ViT-B/384 at full width and
    depth (random weights from a seeded generator), through the port's
    entry points: examples/torch_test_vit.py's experiment_basic on the
    ImageFolder at ``root`` (loader ->
    calib_batch -> PTQ4ViT W8A8 into a checkpoint -> test_classification),
    the data plane and the loader's img/s; then a calibration of the conv
    and blocks 0-5 into a fresh checkpoint directory and a resumed one of
    every op (only the rest searched, B1 / B2 / B3 exactly as their
    searches need, the qstate equal to experiment_basic's uninterrupted one in
    every slot), a W6A6 calibration on the same directory (every op
    searched again), min-max calibration, bias correction, and the raw
    net on the float route and the uint8 route (bitwise equal logits).
    Returns ({path: launches}, summary)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import torch_test_vit as tv
    from ptq4vit_tpu_torch import native
    from ptq4vit_tpu_torch.calib.calibrator import (apply_bias_correction,
                                                    minmax_calib)
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models.net_wrap import wrap_certain_modules_in_net
    from ptq4vit_tpu_torch.parallel import Evaluator
    from ptq4vit_tpu_torch.utils import datasets as D
    name = "vit_base_patch16_384"
    by_path, summary = {}, {"path": EXAMPLE_PATH}
    with tempfile.TemporaryDirectory(prefix="ptq4vit_smoke_") as tmp:
        # examples/torch_test_vit.py, as a user calls it
        args = tv.parse_args(argv=[
            "--dataset_root", root, "--calib_size", str(NUM_CALIB),
            "--max_iteration", "2",
            "--checkpoint_dir", os.path.join(tmp, "ck_example")])
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.time()
        out = tv.experiment_basic(net=name, config="PTQ4ViT", args=args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = sk.launch_counts()
        by_path[EXAMPLE_PATH] = launches
        net, whole, calib = out["net"], out["qstate"], out["calib"]
        ops = [n for n, _ in net.op_inventory]
        report = out["report"]
        log(f"[calib] {EXAMPLE_PATH} on the ImageFolder ({NUM_CALIB} calib "
            f"images, 2 x 32 val images): {wall:.2f} s wall, capture "
            f"{report.capture_seconds:.2f} s, search "
            f"{sum(report.search_seconds.values()):.2f} s, accuracy "
            f"{out['accuracy']:.4f}, launches {launches}")
        check_launches(EXAMPLE_PATH, launches)
        check_qstate(net, whole, EXAMPLE_PATH)
        if sorted(os.listdir(args.checkpoint_dir)) != sorted(
                f"{n}.npz" for n in ops):
            raise AssertionError("experiment_basic's checkpoint directory "
                                 "does not hold one file per op")
        summary.update(example_wall_s=wall, accuracy=out["accuracy"],
                       capture_s=report.capture_seconds,
                       search_s=sum(report.search_seconds.values()))

        # the data plane and the loader's rate (the files were just
        # written, so they are in the page cache)
        g = D.ViTImageNetLoaderGenerator(root, "imagenet", 32, 32, 16,
                                         kwargs={"model": net})
        rates = []
        for _ in range(2):
            t0 = time.time()
            n_img = sum(len(y) for _, y in g.test_loader())
            rates.append(n_img / (time.time() - t0))
        summary.update(native=native.available(),
                       native_path=g.test_transform.wants_bytes,
                       loader_img_per_s=rates)
        log(f"[data] native data plane available: {native.available()}, "
            f"the loader's transform takes it: "
            f"{g.test_transform.wants_bytes}; loader of {n_img} val images "
            f"(batch 32, 16 threads): {rates[0]:.1f} then {rates[1]:.1f} "
            "img/s")

        # part of the ops into a fresh directory, then every op resumed
        cfg = ptq4vit()
        ck = os.path.join(tmp, "ck_resume")
        # the head has no block index, so wrap_certain_modules_in_net
        # would keep it in any block subset: leave it to the second part
        part = wrap_certain_modules_in_net(
            net, cfg, layers=range(6),
            modules_to_wrap=sorted({n.rsplit(".", 1)[-1] for n in ops}
                                   - {"head"}),
            wrap_embedding=True)
        path = f"{EXAMPLE_PATH}, blocks 0-5 into a checkpoint"
        q1, r1, launches, _ = calibrate_counted(
            path, sk, net, calib, cfg, checkpoint_dir=ck,
            wrapped_modules=part)
        by_path[path] = launches
        if set(r1.search_seconds) != set(part) or set(q1) != set(part):
            raise AssertionError(f"{path}: searched other ops than the part")
        rest = [n for n in ops if n not in part]
        resumed, r2, launches, wall = calibrate_counted(
            RESUME_PATH, sk, net, calib, cfg, checkpoint_dir=ck)
        by_path[RESUME_PATH] = launches
        if sorted(r2.search_seconds) != sorted(rest):
            raise AssertionError(f"{RESUME_PATH}: searched "
                                 f"{sorted(r2.search_seconds)}, expected "
                                 f"the {len(rest)} ops of blocks 6-11 and "
                                 "the head")
        expect = search_launches(cfg, net.op_inventory, net.op_shapes,
                                 set(rest))
        check_exact_launches(RESUME_PATH, launches, expect)
        diff = slot_diff(resumed, whole)
        summary.update(resume_searched=len(rest), resume_wall_s=wall,
                       resume_launches=launches, resume_slot_diffs=len(diff))
        log(f"[calib] {RESUME_PATH}: {len(rest)} ops searched, launches "
            f"{launches} (expected {expect}); slots that differ from the "
            f"uninterrupted qstate of experiment_basic: {len(diff)} "
            f"{diff[:8]}")
        if diff or list(resumed) != ops:
            raise AssertionError(f"{RESUME_PATH}: the resumed qstate differs "
                                 "from the uninterrupted one")

        # a changed scope: every op searched again
        path = f"{EXAMPLE_PATH}, W6A6 on the same checkpoint"
        q6, r6, launches, _ = calibrate_counted(
            path, sk, net, calib, ptq4vit().set_bits(6, 6),
            checkpoint_dir=ck)
        by_path[path] = launches
        if sorted(r6.search_seconds) != sorted(ops) or \
                q6["blocks.0.attn.qkv"].w_bit != 6:
            raise AssertionError(f"{path}: not every op was searched again")
        check_qstate(net, q6, path)

        # min-max and bias correction (plain PyTorch, no kernel)
        path = f"{EXAMPLE_PATH}, minmax_calib and apply_bias_correction"
        x4 = torch.from_numpy(calib[:4]).cuda()
        snapshot = [t.clone() for t in _leaves(net.params)]
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        mm = minmax_calib(net, cfg, calib)
        corrected = apply_bias_correction(net, resumed, calib)
        torch.cuda.synchronize()
        launches = sk.launch_counts()
        by_path[path] = launches
        check_launches(path, launches)
        check_qstate(net, mm, "minmax_calib")
        with torch.no_grad():
            fp = net.apply(x4)
            mm_logits = net.apply(x4, qstate=mm)
            q_logits = net.apply(x4, qstate=resumed)
            bc_logits = net.forward(corrected, x4, net.cfg, qstate=resumed)
        if not (torch.isfinite(mm_logits).all()
                and torch.isfinite(bc_logits).all()):
            raise AssertionError("min-max or bias-corrected logits are not "
                                 "finite")
        if any(not torch.equal(a, b) for a, b in
               zip(snapshot, _leaves(net.params))):
            raise AssertionError("apply_bias_correction changed net.params")
        changed = sum(not torch.equal(a, b) for a, b in
                      zip(_leaves(net.params), _leaves(corrected)))
        if changed == 0:
            raise AssertionError("apply_bias_correction changed no bias")

        def cos(a, b):
            return [round(float(c), 5) for c in
                    torch.nn.functional.cosine_similarity(a, b, dim=-1)]
        summary.update(minmax_cosine=cos(mm_logits, fp),
                       bias_corrected_cosine=cos(bc_logits, fp),
                       searched_cosine=cos(q_logits, fp),
                       biases_changed=changed)
        log(f"[calib] minmax_calib W8A8, 4 images: cosine(quant, fp32) "
            f"{summary['minmax_cosine']}; the searched qstate's "
            f"{summary['searched_cosine']}; apply_bias_correction changed "
            f"{changed} biases, cosine(corrected, fp32) "
            f"{summary['bias_corrected_cosine']}")
        del snapshot, corrected

        # the raw net on the float route and the uint8 route
        dc = net.data_config
        kw = dict(crop_pct=dc.crop_pct, mean=dc.mean, std=dc.std,
                  interpolation=dc.interpolation)
        routes = []
        for ev, tf in (
                (Evaluator(net), D.EvalTransform(dc.input_size,
                                                 use_native="never", **kw)),
                (Evaluator(net, data_config=dc),
                 D.EvalTransform(dc.input_size, raw_uint8=True, **kw))):
            ds = D.ImageFolderDataset(os.path.join(root, "val"), tf)
            logits, ys = [], []
            for x, y in D.Loader(ds, 16, num_workers=16):
                logits.append(ev.logits(x))
                ys.append(torch.from_numpy(y).cuda())
            logits, ys = torch.cat(logits), torch.cat(ys)
            routes.append((logits, float((logits.argmax(-1) == ys)
                                         .float().mean())))
        (lf, acc_f), (lu, acc_u) = routes
        n_diff = int((lf != lu).sum())
        summary.update(float_route_accuracy=acc_f, uint8_route_accuracy=acc_u,
                       route_logits_differing=n_diff)
        log(f"[data] raw fp32 net on the {len(lf)} val images: float route "
            f"accuracy {acc_f:.4f}, uint8 route (Evaluator(data_config=)) "
            f"accuracy {acc_u:.4f}, logits that differ: {n_diff} of "
            f"{lf.numel()}")
        if n_diff:
            raise AssertionError("the float and uint8 routes' logits differ")
    del net, whole, resumed, q1, q6, mm
    torch.cuda.empty_cache()
    return by_path, summary


def driver_call(fn, *a, **kw):
    """``fn(*a, **kw)`` with its stdout caught and logged line by line
    under a ``[driver]`` prefix (this script's own JSON lines stay the
    only ones); returns ``fn``'s result."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*a, **kw)
    finally:
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(f"[driver] {line}")


def counted(path, sk, sv, fn, *a, **kw):
    """``driver_call(fn, ...)`` with every launch count set to 0 just
    before and read just after; returns (result, launches, wall s)."""
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    sv.reset_launch_counts()
    t0 = time.time()
    out = driver_call(fn, *a, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**sk.launch_counts(), **sv.launch_counts()}
    log(f"[drivers] {path}: {wall:.2f} s wall, launches {launches}")
    return out, launches, wall


def model_ops(name):
    """(op inventory, op shapes) of the zoo model ``name``."""
    from ptq4vit_tpu_torch.models import model_config, swin, vit
    cfg = model_config(name)
    mod = swin if isinstance(cfg, swin.SwinConfig) else vit
    return mod.op_inventory(cfg), mod.op_shapes(cfg)


def inventory(name):
    return model_ops(name)[0]


def drivers_phase(sk, sv, root):
    """Phase 10, the measurement and experiment drivers, in process, at
    full width and depth (random weights from a seeded generator), each
    path with the launch counts set to 0 just before and read just after:
    bench_torch.py on ViT-B/384 (BENCH_CALIB images, BENCH_REPEATS
    repeats) and Swin-B/384 (one repeat), each final row logged as a
    [bench] line, its intervals finite and positive, its peak memory below
    the card's, B1 / B2 / B3 (B3f) launched exactly as the searches need;
    bench_infer_torch.py at ViT-B/384 (INFER_ITERS timed calls and one
    warm-up a mode; finite logits, img/s a mode; B6 and B7 exactly as the
    fused forwards need); scripts/torch_serve_e2e_bench.py at ViT-B/384
    (E2E_BATCHES batches and one warm-up a mode; the uint8 route's logits
    bitwise the float route's); one cell of examples/torch_test_all.py
    (BasePTQ W6A6, hessian, BENCH_CALIB synthetic images) and of
    examples/torch_test_ablation.py (hessian, no_softmax and no_postgelu,
    W8A8); examples/torch_get_int.py with --activations on the
    ImageFolder at ``root`` (8 calibration images), its npz reread; and
    examples/torch_stability.py, 2 seeds, --quick, on the ImageFolder.
    Returns ({path: launches}, summary)."""
    for d in (ROOT, os.path.join(ROOT, "examples"),
              os.path.join(ROOT, "scripts")):
        if d not in sys.path:
            sys.path.insert(0, d)
    import bench_infer_torch
    import bench_torch
    import torch_get_int
    import torch_serve_e2e_bench
    import torch_stability
    import torch_test_ablation
    import torch_test_all
    import torch_test_vit as tv
    by_path, summary = {}, {"path": "drivers"}
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30

    # bench_torch.py, in process, its stdout contract caught
    for path, model, repeats in (
            (BENCH_VIT, "vit_base_patch16_384", BENCH_REPEATS),
            (BENCH_SWIN, "swin_base_patch4_window12_384", 1)):
        out, err = io.StringIO(), io.StringIO()
        (rc, row, qstate), launches, wall = counted(
            path, sk, sv, bench_torch.run,
            {"BENCH_MODEL": model, "BENCH_CALIB": str(BENCH_CALIB),
             "BENCH_REPEATS": str(repeats)}, out, err)
        by_path[path] = launches
        for line in err.getvalue().splitlines():
            log(f"[bench] {line}")
        lines = out.getvalue().splitlines()
        log(f"[bench] {lines[-1]}")
        if rc != 0 or len(lines) != 2 or not json.loads(lines[0])["startup"]:
            raise AssertionError(f"{path}: bench_torch exited {rc}: "
                                 f"{lines[-1]}")
        inv = inventory(model)
        per_run = model_launches(model)
        check_exact_launches(path, launches,
                             {k: v * repeats for k, v in per_run.items()})
        check_qstate(types.SimpleNamespace(op_inventory=inv), qstate, path)
        for k in ("value", "median", "capture_s", "search_s", "peak_gib"):
            if not (math.isfinite(row[k]) and row[k] > 0):
                raise AssertionError(f"{path}: {k} = {row[k]}")
        if row["peak_gib"] >= card_gib:
            raise AssertionError(f"{path}: peak {row['peak_gib']:.2f} GiB "
                                 f"of a {card_gib:.2f} GiB card")
        summary[path] = {k: row[k] for k in (
            "value", "median", "all_minutes", "capture_s", "search_s",
            "other_s", "num_groups", "peak_gib", "build_s")}
        del qstate
        torch.cuda.empty_cache()

    # bench_infer_torch.py and the end-to-end serving bench, ViT-B/384
    (rc, row, logits), launches, _ = counted(
        INFER_PATH, sk, sv, bench_infer_torch.run,
        {"BENCH_ITERS": str(INFER_ITERS)})
    by_path[INFER_PATH] = launches
    if rc != 0:
        raise AssertionError(f"{INFER_PATH}: {row.get('error')}")
    # the fused and the relaxed modes, a warm-up and INFER_ITERS calls each
    per_call = dict(serve_launches("vit_base_patch16_384", True))
    for k, n in serve_launches("vit_base_patch16_384").items():
        per_call[k] = per_call.get(k, 0) + n
    check_exact_launches(INFER_PATH, launches, {
        k: n * (INFER_ITERS + 1) for k, n in per_call.items()})
    summary[INFER_PATH] = {m: row[m] for m in bench_infer_torch.MODES}
    log(f"[bench_infer] img/s at 32 images: " + ", ".join(
        f"{m} {row[m]:.1f}" for m in bench_infer_torch.MODES))
    del logits
    (rc, row, logits), launches, _ = counted(
        E2E_PATH, sk, sv, torch_serve_e2e_bench.run,
        {"BENCH_NBATCH": str(E2E_BATCHES)})
    by_path[E2E_PATH] = launches
    if rc != 0 or row["u8_equals_f32"] is not True:
        raise AssertionError(f"{E2E_PATH}: the uint8 route's logits differ "
                             f"from the float route's, or it failed: {row}")
    modes = torch_serve_e2e_bench.MODES
    check_exact_launches(E2E_PATH, launches, {
        k: n * len(modes) * (E2E_BATCHES + 1)
        for k, n in serve_launches("vit_base_patch16_384").items()})
    summary[E2E_PATH] = {m: row[m] for m in modes}
    log(f"[serve_e2e] img/s, {E2E_BATCHES} batches of 32 a mode, the copy "
        "included: " + ", ".join(f"{m} {row[m]:.1f}" for m in modes)
        + "; uint8 logits bitwise the float ones")
    del logits
    torch.cuda.empty_cache()

    # one cell each of the grids, on synthetic images
    args = tv.parse_args(torch_test_all.grid_filters, argv=[
        "--synthetic", "--calib_size", str(BENCH_CALIB),
        "--max_iteration", "1"])
    out, launches, wall = counted(
        TEST_ALL_PATH, sk, sv, torch_test_all.test_all,
        "vit_base_patch16_384", torch_test_all.CfgModifier(
            linear_ptq_setting=(1, 1, 1), metric="hessian",
            bit_setting=(6, 6)),
        calib_size=BENCH_CALIB, config_name="BasePTQ", args=args)
    by_path[TEST_ALL_PATH] = launches
    check_launches(TEST_ALL_PATH, launches)
    check_qstate(out["net"], out["qstate"], TEST_ALL_PATH)
    if out["qstate"]["blocks.0.mlp.fc1"].w_bit != 6:
        raise AssertionError(f"{TEST_ALL_PATH}: not W6A6")
    summary[TEST_ALL_PATH] = {k: out[k] for k in (
        "calib_minutes", "capture_seconds", "search_seconds", "peak_gib")}
    del out
    out, launches, wall = counted(
        ABLATION_PATH, sk, sv, torch_test_ablation.test_all_ablation,
        "vit_base_patch16_384", torch_test_ablation.CfgModifier(
            linear_ptq_setting=(1, 1, 1), metric="hessian", search_round=3,
            bit_setting=(8, 8), no_softmax=True, no_postgelu=True),
        calib_size=BENCH_CALIB, args=args)
    by_path[ABLATION_PATH] = launches
    check_launches(ABLATION_PATH, launches)
    q = out["qstate"]
    check_qstate(out["net"], q, ABLATION_PATH)
    if q["blocks.0.mlp.fc2"].postgelu or \
            q["blocks.0.attn.matmul2"].split is not None:
        raise AssertionError(f"{ABLATION_PATH}: a twin quantizer is left")
    summary[ABLATION_PATH] = {"wall_s": wall}
    del out, q
    torch.cuda.empty_cache()

    # get_int and stability on the ImageFolder
    with tempfile.TemporaryDirectory(prefix="ptq4vit_smoke_int_") as tmp:
        args = tv.parse_args(argv=["--dataset_root", root, "--calib_size",
                                   "8", "--max_iteration", "1"])
        npz, launches, _ = counted(
            GET_INT_PATH, sk, sv, torch_get_int.get_int_weights,
            "vit_base_patch16_384", "PTQ4ViT", args=args,
            out_dir=os.path.join(tmp, "int_weights"), activations=True)
        by_path[GET_INT_PATH] = launches
        check_launches(GET_INT_PATH, launches)
        inv = inventory("vit_base_patch16_384")
        with np.load(npz) as z:
            kinds = {}
            for k in z.files:
                kinds.setdefault(k.split(":")[0], []).append(z[k])
        weighted = [n for n, t in inv if "qmatmul" not in t]
        if len(kinds.get("weight", [])) != len(weighted) or any(
                a.dtype != np.int8 for a in kinds["weight"]):
            raise AssertionError(f"{GET_INT_PATH}: {len(kinds['weight'])} "
                                 f"int8 weights, expected {len(weighted)}")
        if any(a.dtype != np.float32 or not np.all(np.isfinite(a))
               or not np.all(a > 0) for a in kinds["interval"]):
            raise AssertionError(f"{GET_INT_PATH}: an interval is not "
                                 "finite positive float32")
        if not kinds.get("act") or any(a.dtype not in (np.int8, np.uint8)
                                       for a in kinds["act"]):
            raise AssertionError(f"{GET_INT_PATH}: no int activations")
        summary[GET_INT_PATH] = {k: len(v) for k, v in kinds.items()}
        log(f"[get_int] {os.path.basename(npz)} reread: "
            f"{summary[GET_INT_PATH]} arrays by kind")
    args = tv.parse_args(argv=["--dataset_root", root, "--calib_size", "8",
                               "--max_iteration", "1", "--quick"])
    accs, launches, _ = counted(STABILITY_PATH, sk, sv,
                                torch_stability.stability,
                                "vit_base_patch16_384", "PTQ4ViT", seeds=2,
                                args=args)
    by_path[STABILITY_PATH] = launches
    check_launches(STABILITY_PATH, launches)
    if len(accs) != 2 or not all(0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{STABILITY_PATH}: top-1 {accs}")
    summary[STABILITY_PATH] = {"top1": accs}
    torch.cuda.empty_cache()
    return by_path, summary


# ---------------------------------------------------------------------------
# the search kernels' candidate chunks (phase 3), the large models' kernel
# shapes (phase 3) and their paths (phase 12)
# ---------------------------------------------------------------------------

def call_scratch(sk, kname, args):
    """The (fixed, per candidate) scratch bytes and the candidates of a
    search kernel case's call (``ops/search_kernels.py`` ``*_scratch``)."""
    if kname.startswith("matmul"):
        A, B, _, cands, _, mode = args[:6]
        return sk.matmul_scratch(*A.shape, B.shape[-1], mode), cands.shape[0]
    if kname == "linear_w_hessian_sims_i8":
        x_lv, x_neg, w, cands = args[0], args[1], args[4], args[5]
        n_V = cands.shape[1] if cands.ndim == 2 else 1
        return sk.linear_w_scratch(*x_lv.shape, w.shape[0], n_V,
                                   x_neg is not None), cands.shape[0]
    if kname == "linear_a_hessian_sims_i8":
        return sk.linear_a_scratch(*args[0].shape, args[1].shape[0],
                                   args[7]), args[3].shape[0]
    cands = args[2]
    if kname == "linear_w_hessian_sims":
        n_V = cands.shape[1] if cands.ndim == 2 else 1
        return sk.linear_w_f32_scratch(*args[0].shape, args[1].shape[0],
                                       n_V), cands.shape[0]
    return sk.linear_a_f32_scratch(*args[0].shape, args[1].shape[0],
                                   args[6]), cands.shape[0]


def call_plans(sk, kname, args, sizes, dev):
    """The plan of a search kernel case's call for each candidate count in
    ``sizes`` (the whole call's, a chunk's): B1 / B2 ``linear_plan``, B4w /
    B4a ``fp32_plan``, B3 / B3f ``matmul_plan``."""
    if kname.startswith("matmul"):
        A, B, mode = args[0], args[1], args[5]
        return [sk.matmul_plan(*A.shape, B.shape[-1], n, mode)
                for n in sizes]
    M, K = args[0].shape
    if kname == "linear_w_hessian_sims_i8":
        cands = args[5]
        n_V = cands.shape[1] if cands.ndim == 2 else 1
        return [sk.linear_plan("w", M, args[4].shape[0], K, n, n_V,
                               args[1] is not None) for n in sizes]
    if kname == "linear_a_hessian_sims_i8":
        return [sk.linear_plan("a", M, args[1].shape[0], K, n)
                for n in sizes]
    kind = "w" if kname == "linear_w_hessian_sims" else "a"
    twin = kind == "a" and args[6]
    return [sk.fp32_plan(kind, M, args[1].shape[0], K, n, twin,
                         sk._num_sms(dev)) for n in sizes]


def chunk_cases(sk, cases, stats, dev):
    """Each search wrapper's first case cut by a scratch bound
    (``scratch_bound``) into chunks of CHUNK candidates against the whole
    call: every sim bitwise, one launch a chunk, one chunked call; the
    plans of the whole call and of the chunks, and both calls' times (the
    chunks repeat the fixed side's level pre-pass once each) go to the
    kernel's cases."""
    seen = set()
    for kname, label, args, fn, _, _ in cases:
        if kname in seen:
            continue
        seen.add(kname)
        wrapper = getattr(sk, kname)
        (fixed, per), P = call_scratch(sk, kname, args)
        bound = fixed + CHUNK * per
        sizes = sorted({min(CHUNK, P - p0) for p0 in range(0, P, CHUNK)},
                       reverse=True)

        def chunked(wrapper=wrapper, args=args, bound=bound):
            return wrapper(*args, scratch_bound=bound)
        whole = fn()
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        got = chunked()
        torch.cuda.synchronize()
        launches, calls = sk.launch_counts()[kname], sk.chunked_calls()
        if launches != -(-P // CHUNK) or calls != 1:
            raise AssertionError(f"{kname} {label}: {launches} launches, "
                                 f"{calls} chunked calls in chunks of "
                                 f"{CHUNK} of {P}")
        if not torch.equal(got, whole):
            raise AssertionError(
                f"{kname} {label}: chunks of {CHUNK} differ from the whole "
                f"call in {int((got != whole).sum())} of {whole.numel()} "
                "sims")
        whole_ms, chunk_ms = time_ms(fn, 3, 0), time_ms(chunked, 3, 0)
        plans = call_plans(sk, kname, args, [P] + sizes, dev)
        entry = {"case": f"{label}, chunks of {CHUNK} (scratch bound "
                         f"{bound} bytes)", "bitwise": True,
                 "launches": launches, "ms": chunk_ms, "whole_ms": whole_ms,
                 "scratch_bytes": [fixed + P * per, bound],
                 "plans": [dict(p._asdict(), candidates=n)
                           for n, p in zip([P] + sizes, plans)]}
        log(f"[chunks] {kname} {label}: {P} candidates in {launches} "
            f"chunks of at most {CHUNK}, every sim bitwise the whole "
            f"call's; scratch {fixed + P * per} -> {bound} bytes; "
            f"{chunk_ms:.3f} ms against {whole_ms:.3f} ms whole; plans "
            + "; ".join(f"{n}: {p}" for n, p in zip([P] + sizes, plans)))
        stats[kname]["cases"].append(entry)
        del whole, got
    torch.cuda.empty_cache()


# search kernel shapes at 4 images: linears (label, M, K, N, post-GELU,
# exact scoring: B4w / B4a, else B1 / B2) and attention matmuls (label,
# samples, heads, tokens, head dim, modes)
S4 = 4
LARGE_LINEARS = (
    ("ViT-L/384 fc2 twin", S4 * 577, 4096, 1024, True, False),
    ("Swin-L/384 stage 4 fc2 twin", S4 * 144, 6144, 1536, True, False),
    ("Swin-B/384 stage 1 fc1", S4 * 9216, 128, 512, False, True))
LARGE_MATMULS = (
    ("ViT-L/384 (16 heads)", S4, 16, 577, 64, ("a",)),
    ("Swin-L/384 stage 1 (6 heads, 64 windows)", S4 * 64, 6, 144, 32,
     ("b_sos",)),
    ("Swin-L/384 stage 4 (48 heads, one window)", S4, 48, 144, 32,
     ("b",)))
# the 224-px grid: Swin-T stage 1 (3136 tokens, C 96) fc1 and its twin
# fc2; window 7 (N = 49, 15 of a 64-wide tile idle) at Swin-T's 3 heads
# (B3) and Swin-B/224's 4 (B3f, fold 4); ViT-S/32's 6 heads at N = 50
# (B3f, fold 2)
GRID_LINEARS = (
    ("Swin-T stage 1 fc1", S4 * 3136, 96, 384, False, False),
    ("Swin-T stage 1 fc2 twin", S4 * 3136, 384, 96, True, False))
GRID_MATMULS = (
    ("Swin-T stage 1 (3 heads, window 7, 64 windows)", S4 * 64, 3, 49, 32,
     ("a", "b", "b_sos")),
    ("Swin-B/224 stage 1 (4 heads, window 7, 64 windows)", S4 * 64, 4, 49,
     32, ("a", "b", "b_sos")),
    ("ViT-S/32 (6 heads, N = 50)", S4, 6, 50, 64, ("a", "b_sos")))


def shape_search_cases(sk, dev, linears, matmuls, seed):
    """Search kernel cases at the shapes given (``linears``,
    ``matmuls``: as LARGE_LINEARS / LARGE_MATMULS), as measure_search
    takes them (P = 100), each call's plan logged: B1 and B2 (twin / post-
    GELU where the input is), or B4w and B4a under exact scoring, at each
    linear; B3, or B3f where the shape's head fold is above 1, in each
    mode of each matmul."""
    from ptq4vit_tpu_torch.quant.fakequant import GELU_NEG_CLIP
    rng = np.random.default_rng(seed)
    P, q = 100, 128
    grid = np.linspace(0.01, 1.2, P + 1)[:P].astype(np.float32)
    a_neg = np.float32(GELU_NEG_CLIP / q)
    i8 = torch.int8
    cases = []

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def case(kname, label, args, ref_name=None):
        fn, ref = getattr(sk, kname), getattr(sk, ref_name or kname + "_ref")
        cases.append((kname, label, args, lambda: fn(*args),
                      lambda: ref(*args), None))
        log(f"[plan] {kname} {label}: "
            f"{call_plans(sk, kname, args, [P], dev)[0]}")

    for label, M, ic, oc, pg, exact in linears:
        x = rng.standard_normal((M, ic)).astype(np.float32)
        if pg:
            x = x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
        w = (rng.standard_normal((oc, ic)) * (2 / (ic + oc)) ** 0.5) \
            .astype(np.float32)
        raw = (x @ w.T).astype(np.float32)
        g = (rng.standard_normal((M, oc)) * 1e-4).astype(np.float32)
        a = np.float32((x.max() if pg else np.abs(x).max()) / (q - 0.5))
        x_lv = np.clip(np.round(x / a), 0 if pg else -q, q - 1)
        w_int = np.float32(np.abs(w).max() / (q - 0.5))
        w_lv = np.clip(np.round(w / w_int), -q, q - 1)
        cw, ca = t(grid * w_int), t(grid * a)
        if exact:           # B4w / B4a
            case("linear_w_hessian_sims", label,
                 (t(x_lv * a), t(w), cw, t(raw), t(g), q))
            case("linear_a_hessian_sims", label,
                 (t(x), t(w_lv * w_int), ca, t(raw), t(g), q, False, 0.0))
            continue
        x_neg = np.clip(np.round(x / a_neg), -q, 0) if pg else None
        case("linear_w_hessian_sims_i8", label,
             (t(x_lv, i8), t(x_neg, i8) if pg else None, float(a),
              float(a_neg) if pg else None, t(w), cw, t(raw), t(g), q))
        case("linear_a_hessian_sims_i8", label,
             (t(x), t(w_lv, i8), t(np.full(oc, w_int, np.float32)), ca,
              t(raw), t(g), q, pg, GELU_NEG_CLIP / q if pg else 0.0))
    for label, S_, G, N, hd, modes in matmuls:
        for mlabel, args in matmul_cases(rng, grid, S_, G, N, hd, q, t,
                                         modes):
            fold = sk.mm_fold_factor(G, args[0].shape[-1], args[1].shape[-1])
            case("matmul_hessian_sims_b3f" if fold > 1
                 else "matmul_hessian_sims_b3", f"{label} {mlabel}", args,
                 "matmul_hessian_sims_ref")
    return cases


# B6 at the large models' shapes with SERVE_BATCH images, as B6_CASES
LARGE_B6_CASES = (
    ("ViT-L/384 fc1: LN, quantize -> GELU -> twin int8", SERVE_BATCH * 577,
     1024, 4096, "f", True, True, "twin", torch.bfloat16),
    ("ViT-L/384 fc2: twin int8 in -> + residual", SERVE_BATCH * 577, 4096,
     1024, "q8twin", False, False, "residual", torch.bfloat16),
    ("Swin-L/384 stage 1 fc1: LN, quantize -> GELU -> twin int8",
     SERVE_BATCH * 9216, 192, 768, "f", True, True, "twin", torch.bfloat16),
    ("Swin-L/384 stage 4 fc2: twin int8 in -> + residual",
     SERVE_BATCH * 144, 6144, 1536, "q8twin", False, False, "residual",
     torch.bfloat16))
# B10 / B11 and B9 at Swin-L/384's stages 1 and 4
LARGE_WINDOW_STAGES = ((1, 96, 192), (4, 12, 1536))
LARGE_WINDOW_ATTN_STAGES = ((1, 96, 6, 6, ("int8 SoS",)),
                            (4, 12, 48, 0, ("int8 SoS",)))


def large_kernel_phase(sk, sv, dev):
    """Phase 3's cases at the large models' shapes, each kernel against
    its plain version under the rules of its family: the search kernels
    (``shape_search_cases`` at LARGE_LINEARS / LARGE_MATMULS), B6 at
    ViT-L/384's fc1 / fc2 and Swin-L/384's stage-1 fc1 (C 192) and stage-4
    fc2 (K 6144) (each call's q8_plan logged), B7 int8 -> int8 SoS at
    ViT-L/384's 16 heads, B10 / B11 and B9 int8 -> int8 SoS at
    Swin-L/384's stages 1 (6 heads, shifted) and 4 (48 heads, one window),
    all with SERVE_BATCH images.  Returns the stats by kernel."""
    stats = measure_search(shape_search_cases(sk, dev, LARGE_LINEARS,
                                              LARGE_MATMULS, 17))
    rng = np.random.default_rng(18)
    cases = []
    for c in LARGE_B6_CASES:
        cases.append(b6_case(sv, rng, *c)[0])
        log(f"[plan] q8_linear {c[0]}: "
            f"{sv.q8_plan(c[1], c[3], c[4], c[7] == 'residual')}")
    cases += vit_attention_cases(sv, dev, rng, H=16,
                                 tag="ViT-L/384 16 heads: ", full=False)
    cases += window_kernel_cases(sv, dev, LARGE_WINDOW_STAGES,
                                 LARGE_WINDOW_ATTN_STAGES, "Swin-L/384 ",
                                 relaxed=False, seed=19)
    merge_stats(stats, measure_serving(cases))
    return stats


# B6 at the 224-px models' shapes with SERVE_BATCH images, as B6_CASES:
# Swin-T stage 1 (res 56, C 96) fc1 and fc2, the distilled DeiT-S's second
# head; then fc1's relaxed variant on the same inputs
GRID_B6_CASES = (
    ("Swin-T stage 1 fc1: LN, quantize -> GELU -> twin int8",
     SERVE_BATCH * 3136, 96, 384, "f", True, True, "twin", torch.bfloat16),
    ("Swin-T stage 1 fc2: twin int8 in -> + residual", SERVE_BATCH * 3136,
     384, 96, "q8twin", False, False, "residual", torch.bfloat16),
    ("DeiT-S distilled head_dist: quantize -> float", SERVE_BATCH, 384, 1000,
     "f", False, False, "float", torch.bfloat16))
GRID_RELAXED_B6 = ((GRID_B6_CASES[0][0], None),)
# B7 at the ViT / DeiT token counts (tag, heads, N)
GRID_ATTENTION = (("ViT-S/32 6 heads, N = 50: ", 6, 50),
                  ("DeiT-S distilled 6 heads, N = 198: ", 6, 198),
                  ("DeiT-T 3 heads, N = 197: ", 3, 197))
# B10 / B11 and B9 at Swin-T's window 7 (N = 49): stage 1 (res 56, C 96,
# 3 heads, shifted: 64 masks) and stage 4 (res 7, one clamped window, 24
# heads, no mask)
GRID_WINDOW_STAGES = ((1, 56, 96),)
GRID_WINDOW_ATTN_STAGES = ((1, 56, 3, 3, ("int8 SoS", "float SoS")),
                           (4, 7, 24, 0, ("int8 SoS",)))


def grid_kernel_phase(sk, sv, dev):
    """Phase 3's cases at the 224-px models' shapes, each kernel against
    its plain version under the rules of its family: the search kernels
    (``shape_search_cases`` at GRID_LINEARS / GRID_MATMULS: B1 / B2 at
    Swin-T's stage 1, B3 at window 7 with 3 heads, B3f at 4 and at
    ViT-S/32's N = 50), B6 at GRID_B6_CASES (each call's q8_plan logged)
    and fc1's relaxed variant, B7 int8 -> int8 SoS and its relaxed variant
    at GRID_ATTENTION, B10 / B11 and B9 at Swin-T's window 7
    (GRID_WINDOW_STAGES, GRID_WINDOW_ATTN_STAGES) with B10's and B9's
    relaxed variants at stage 1, all with SERVE_BATCH images.  Returns
    the stats by kernel."""
    stats = measure_search(shape_search_cases(sk, dev, GRID_LINEARS,
                                              GRID_MATMULS, 20))
    rng = np.random.default_rng(21)
    cases, inputs = [], {}
    for c in GRID_B6_CASES:
        case, args, kw = b6_case(sv, rng, *c)
        cases.append(case)
        inputs[c[0]] = (args, kw)
        log(f"[plan] q8_linear {c[0]}: "
            f"{sv.q8_plan(c[1], c[3], c[4], c[7] == 'residual')}")
    cases += relaxed_linear_cases(sv, rng, inputs, GRID_RELAXED_B6)
    for tag, H, N in GRID_ATTENTION:
        log(f"[plan] attention {tag}{sv.attn_plan(N, 64)}")
        cases += vit_attention_cases(sv, dev, rng, H=H, tag=tag, full=False,
                                     N=N, relaxed=True)
    log(f"[plan] window attention, window 7: {sv.attn_plan(49, 32)}")
    cases += window_kernel_cases(sv, dev, GRID_WINDOW_STAGES,
                                 GRID_WINDOW_ATTN_STAGES, "Swin-T window 7 ",
                                 relaxed=True, seed=22, ws=7)
    merge_stats(stats, measure_serving(cases))
    return stats


def merge_stats(stats, more):
    """Each kernel's cases of ``more`` after those of ``stats`` (whose
    first case stays the headline), the worst errors of both."""
    for k, st in more.items():
        if k not in stats:
            stats[k] = st
            continue
        stats[k]["cases"] += st["cases"]
        for key in ("max_abs_err", "max_share_off"):
            if key in st:
                stats[k][key] = max(stats[k].get(key, 0.0), st[key])


def model_paths(sk, sv, names, by_path, summaries):
    """Each zoo model of ``names`` at full width and depth through
    quantize (PTQ4ViT W8A8, random weights from a seeded generator, 8
    images, micro-batch 4) with B1 / B2 / B3 / B3f launched exactly as its
    op inventory needs (``model_launches``), served as phase 4 serves,
    then serving_phase on its qstate: MODEL_REQUESTS requests of
    SERVE_BATCH images through the bf16 ServingEngine and
    MODEL_RELAXED_REQUESTS through the relaxed one, launches exactly as
    ``serve_launches`` says, the cosine gates of phase 7.  Adds each
    path's launches to ``by_path`` and its summary to ``summaries``."""
    for name in names:
        t0 = time.time()
        qcpu, launches, summary = calibrate_and_serve(name, name, sk)
        check_exact_launches(name, launches, model_launches(name))
        by_path[name] = launches
        summaries.append(summary)
        launches, summary, (net, qstate, x0, _) = serving_phase(
            sk, sv, name, qcpu, MODEL_REQUESTS, MODEL_RELAXED_REQUESTS)
        by_path[summary["path"]] = launches
        by_path[summary["relaxed"]["path"]] = summary["relaxed"]["launches"]
        summary["model_s"] = time.time() - t0
        summaries.append(summary)
        log(f"[model] {name}: calibrated and served in "
            f"{summary['model_s']:.1f} s")
        del net, qstate, x0
        torch.cuda.empty_cache()


def large_model_phase(sk, sv, q_swin_b):
    """Phase 12: ViT-L/384 and Swin-L/384 through ``model_paths``; then
    Swin-B/384 under exact scoring (B4w / B4a 300 each, B1 - B3f never)
    and its flip count against phase 5's int8-scored qstate ``q_swin_b``
    (same net, images and probe).  Returns ({path: launches}, the
    summaries)."""
    t_phase = time.time()
    by_path, summaries = {}, []
    model_paths(sk, sv, LARGE, by_path, summaries)
    swin_b = "swin_base_patch4_window12_384"
    q_exact, by_path[SWIN_EXACT_PATH], summary = calibrate_and_serve(
        SWIN_EXACT_PATH, swin_b, sk, int8_score=False)
    flips = flip_count(inventory(swin_b), q_swin_b, q_exact)
    summary["flips"] = {"by_op_type": flips,
                        "total": [sum(v[0] for v in flips.values()),
                                  sum(v[1] for v in flips.values())]}
    summaries.append(summary)
    log(f"[flips] int8 vs exact scoring, {swin_b}, {NUM_CALIB} images: "
        + json.dumps(summary["flips"]))
    log(f"[large] phase 12: {time.time() - t_phase:.1f} s")
    return by_path, summaries


def grid_phase(sk, sv):
    """Phase 13, the paper's 224-px grid: ViT-S/32 (N = 50, its matmuls on
    B3f: 6 heads fold by 2), DeiT-T (3 heads), ViT-B/224 (N = 197), the
    distilled DeiT-S (N = 198, two heads averaged), Swin-T (window 7: B3
    at stage 1's 3 heads, B3f past it; stage 4 one clamped window) and
    Swin-B/224 through ``model_paths``.  Returns ({path: launches}, the
    summaries)."""
    t_phase = time.time()
    by_path, summaries = {}, []
    model_paths(sk, sv, GRID, by_path, summaries)
    log(f"[grid] phase 13: {time.time() - t_phase:.1f} s")
    return by_path, summaries


# ---------------------------------------------------------------------------
# phase 11: the device mesh (parallel/): ranks over torch.distributed
# ---------------------------------------------------------------------------

MESH_WORLD = 2
MESH_TIMEOUT_S = 300          # a collective waiting longer fails the rank
MESH_TP_IMAGES = 8            # the tensor-parallel evaluation's images
# the tensor-parallel evaluations (Evaluator(tensor_parallel=True) over
# model=2) by net: mode -> its int8 argument
TP_MODES = {
    "vit_base_patch16_384": {"fake-quant": False, "int8": True,
                             "fused": "fused"},
    "swin_base_patch4_window12_384": {"fused": "fused"},
}
# fused, every rank adds one q8_epilogue for each row-parallel linear (proj
# and fc2 of every block: ViT-B/384 12 blocks, Swin-B/384 24) to the
# single device's launches, its proj / fc2 / B11 launches in partial mode
TP_EPILOGUES = {"vit_base_patch16_384": 24,
                "swin_base_patch4_window12_384": 48}
SLOT_RTOL = 1e-5              # qstate slots: JAX's mesh tolerance
TIE_RTOL = 1e-5               # a flipped pick's two sims within this
# micro-batches of 4 images a rank: each rank's capture runs the single
# device's micro-batch shapes (phase 4's 4 images), so its caches are the
# single device's bitwise (the KL mean over 8 halves every gradient
# exactly) and only the searches' sums over the ranks reorder
MESH_MICRO_BATCH = 4 * MESH_WORLD
MESH_EXACT_PATH = "vit_base_patch16_384 depth 2 exact"
PATHS[MESH_EXACT_PATH] = ({k: None for k in EXACT}, INT8)
# phase 4's micro-batch over the mesh, what quantize(batch_size=4, mesh=)
# gives: 2 images a rank, held against one device on 2-image micro-batches
# (SHARD_PATH, the rank's shapes); both are compared with phase 4, whose
# 4-image forward rounds the captured gradients differently
USER_MICRO_BATCH = 4
USER_KEY = "mesh vit_base_patch16_384 calibration, micro-batch 4"
SHARD_PATH = "vit_base_patch16_384 micro-batch 2"
PATHS[SHARD_PATH] = PATHS["vit_base_patch16_384"]


def exact_depth2_net():
    """ViT-B/384 at full width and depth 2, seeded, on this process's
    card, with phase 4's 8 calibration images."""
    from ptq4vit_tpu_torch.models import model_config, net_from_config, vit
    cfg = dataclasses.replace(model_config("vit_base_patch16_384"), depth=2)
    net = net_from_config(cfg, vit.init_params(
        cfg, np.random.default_rng(0), device="cuda"))
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    return net, calib


def first_request(size):
    """Phase 7's first request (SERVE_BATCH images)."""
    return np.random.default_rng(10).standard_normal(
        (SERVE_BATCH, 3, size, size)).astype(np.float32)


def host_trace(trace):
    """An argmax_trace's records (kept on the card while tracing) on the
    host."""
    return {op: [(s.cpu(), p.cpu()) for s, p in picks]
            for op, picks in trace.items()}


def _counts(sk, sv):
    return {**sk.launch_counts(), **sv.launch_counts()}


def _reset(sk, sv):
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    sv.reset_launch_counts()


def mesh_rank(rank, job_path, out_dir):
    """One rank of phase 11 (started by parallel.launch.spawn): mesh
    calibration of ViT-B/384 and Swin-B/384 and of the exact-scoring
    depth-2 ViT (and of ViT-B/384 at USER_MICRO_BATCH), data-parallel
    serving of both nets on phase 7's first request, and tensor-parallel
    evaluation (TP_MODES: ViT-B/384 fake-quant, int8=True and fused,
    Swin-B/384 fused); the results, the argmax traces and each path's
    launches go to rank{r}.pt."""
    from ptq4vit_tpu_torch import ServingEngine, quantize
    from ptq4vit_tpu_torch.calib import search as S
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops import search_kernels as sk
    from ptq4vit_tpu_torch.parallel import Evaluator, make_mesh
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in build.LIBRARIES:          # built by the parent
        build.load(name)
    job = torch.load(job_path, weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(MESH_WORLD)
    out = {"device": str(dev), "paths": {}}

    def calibrate(key, net, calib, micro_batch=MESH_MICRO_BATCH, **kw):
        _reset(sk, sv)
        t0 = time.time()
        with S.argmax_trace() as trace:
            _, q = quantize(net, calib, config=ptq4vit(),
                            batch_size=micro_batch, mesh=mesh, **kw)
        torch.cuda.synchronize()
        out["paths"][key] = {
            "seconds": time.time() - t0, "launches": _counts(sk, sv),
            "qstate": qstate_to(q, "cpu"), "trace": host_trace(trace)}

    nets, calibs = {}, {}
    for name in BASE:
        net = nets[name] = get_net(name, seed=0)
        size = net.cfg.img_size
        calibs[name] = np.random.default_rng(1).standard_normal(
            (NUM_CALIB, 3, size, size)).astype(np.float32)
        calibrate(f"mesh {name} calibration", net, calibs[name])
    name = "vit_base_patch16_384"
    calibrate(USER_KEY, nets[name], calibs[name], USER_MICRO_BATCH)
    net2, calib2 = exact_depth2_net()
    calibrate(f"mesh {MESH_EXACT_PATH} calibration", net2, calib2,
              int8_score=False)
    del net2
    for name, net in nets.items():
        engine = ServingEngine(net, qstate_to(job["qstates"][name], dev),
                               mesh=mesh)
        x = first_request(net.cfg.img_size)
        engine(x)                                       # warm-up
        _reset(sk, sv)
        t0 = time.time()
        logits = engine(x)
        torch.cuda.synchronize()
        out["paths"][f"mesh {name} serving"] = {
            "seconds": time.time() - t0, "launches": _counts(sk, sv),
            "logits": logits.cpu()}
        del engine
    tp = make_mesh(MESH_WORLD, model_parallel=MESH_WORLD)
    for name, modes in TP_MODES.items():
        x = first_request(nets[name].cfg.img_size)[:MESH_TP_IMAGES]
        for mode, int8 in modes.items():
            ev = Evaluator(nets[name], qstate_to(job["qstates"][name], dev),
                           mesh=tp, tensor_parallel=True, int8=int8)
            _reset(sk, sv)
            t0 = time.time()
            logits = ev.logits(x)
            torch.cuda.synchronize()
            out["paths"][f"mesh {name} tensor-parallel {mode}"] = {
                "seconds": time.time() - t0, "launches": _counts(sk, sv),
                "logits": logits.cpu()}
            del ev
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def nccl_rank(rank, job_path, out_dir):
    """The one-rank NCCL world: ServingEngine(mesh=) on phase 7's first
    request and Evaluator(mesh=) on its first images, ViT-B/384."""
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops import search_kernels as sk
    from ptq4vit_tpu_torch.parallel import Evaluator, make_mesh
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in build.LIBRARIES:
        build.load(name)
    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(1)
    name = "vit_base_patch16_384"
    net = get_net(name, seed=0)
    q = qstate_to(job["qstates"][name], "cuda")
    x = first_request(net.cfg.img_size)
    engine = ServingEngine(net, q, mesh=mesh)
    engine(x)
    _reset(sk, sv)
    logits = engine(x)
    torch.cuda.synchronize()
    serve_launches = _counts(sk, sv)
    n_correct = Evaluator(net, q, mesh=mesh).n_correct(
        x[:MESH_TP_IMAGES], job["labels"])
    torch.save({"backend": torch.distributed.get_backend(),
                "logits": logits.cpu(), "launches": serve_launches,
                "n_correct": n_correct},
               os.path.join(out_dir, f"rank{rank}.pt"))


def slot_flips(q_ref, q_mesh):
    """{op: differing slots} where the two qstates' slots differ by more
    than SLOT_RTOL, and the count of all slots."""
    flips, total = {}, 0
    for op, qp in q_ref.items():
        for f, v in vars(qp).items():
            if not torch.is_tensor(v):
                continue
            w = getattr(q_mesh[op], f)
            same = torch.isclose(w.reshape(-1).float(), v.reshape(-1).float(),
                                 rtol=SLOT_RTOL, atol=0)
            total += same.numel()
            if not same.all():
                flips[op] = flips.get(op, 0) + int((~same).sum())
    return flips, total


def first_divergence_is_tie(trace_ref, trace_mesh, op):
    """The op's picks in the two runs: at the first pick where they
    differ, every differing choice must be a tie of the reference's sims
    (the two candidates' sims within TIE_RTOL); the later picks follow
    from it.  Returns (is a tie, a description)."""
    a, b = trace_ref.get(op, []), trace_mesh.get(op, [])
    if len(a) != len(b):
        return False, f"{len(a)} vs {len(b)} picks"
    for k, ((sims, pa), (_, pb)) in enumerate(zip(a, b)):
        if torch.equal(pa, pb):
            continue
        if pa.ndim == 0:
            s = sims.reshape(-1, 1)
            pa, pb = pa.reshape(1), pb.reshape(1)
        else:
            s = sims.reshape(sims.shape[0], -1)
            pa, pb = pa.reshape(-1), pb.reshape(-1)
        worst = 0.0
        for c in torch.nonzero(pa != pb).reshape(-1).tolist():
            hi, lo = float(s[pa[c], c]), float(s[pb[c], c])
            worst = max(worst, abs(hi - lo) / max(abs(hi), 1e-30))
        return worst <= TIE_RTOL, (f"pick {k}: {int((pa != pb).sum())} "
                                   f"columns, largest relative sim gap "
                                   f"{worst:.2e}")
    return False, "every pick equal, yet the slots differ"


def qstate_diff(q_ref, trace_ref, q, trace):
    """The slots of ``q`` that differ from ``q_ref`` by more than
    SLOT_RTOL, split by whether the op's first differing pick is a tie of
    the reference's sims: (differing slots, all slots, {op: tie},
    {op: not a tie})."""
    flips, total = slot_flips(q_ref, q)
    ties, bad = {}, {}
    for op in flips:
        tie, what = first_divergence_is_tie(trace_ref, trace, op)
        (ties if tie else bad)[op] = f"{flips[op]} slots, {what}"
    return sum(flips.values()), total, ties, bad


def check_mesh_qstate(key, ref, q_ref, trace_ref, ranks):
    """Every rank's qstate the same bytes; against ``ref``'s (one
    device's), every differing slot a tie under TIE_RTOL.  Returns the
    summary."""
    q0 = ranks[0]["paths"][key]["qstate"]
    for r in ranks[1:]:
        for op, qp in r["paths"][key]["qstate"].items():
            for f, v in vars(qp).items():
                if torch.is_tensor(v) and not torch.equal(
                        v, getattr(q0[op], f)):
                    raise AssertionError(f"{key}: rank qstates differ at "
                                         f"{op}.{f}")
    n, total, ties, bad = qstate_diff(q_ref, trace_ref, q0,
                                      ranks[0]["paths"][key]["trace"])
    log(f"[mesh] {key[5:]}: qstate identical on {len(ranks)} ranks; {n} "
        f"of {total} slots differ from {ref} (rtol {SLOT_RTOL}); ties "
        f"{json.dumps(ties)}; not ties {json.dumps(bad)}")
    if bad:
        raise AssertionError(f"{key}: {sorted(bad)} differ from {ref} by "
                             "more than a tie")
    return {"slots_differing": n, "slots": total, "ties": ties}


def mesh_phase(sk, sv, qstates, traces, launches, served):
    """Phase 11: the exact-scoring depth-2 ViT-B/384 and ViT-B/384 on
    2-image micro-batches on one device, then MESH_WORLD ranks (gloo on
    this card, or NCCL on cards of their own) against them and against
    phases 4, 5 and 7 (their qstates, argmax traces, calibration launches
    and served logits), then a one-rank NCCL world.  Returns ({path:
    launches}, summary)."""
    import datetime
    from ptq4vit_tpu_torch.calib import search as S
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.parallel import Evaluator, launch
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    t_phase = time.time()
    by_path, summary = {}, {"path": "mesh"}
    net2, calib2 = exact_depth2_net()
    with S.argmax_trace() as trace_exact:
        q_exact, by_path[MESH_EXACT_PATH], _ = run_path(
            MESH_EXACT_PATH, sk, net2, calib2, config=ptq4vit(),
            int8_score=False)
    q_exact, trace_exact = qstate_to(q_exact, "cpu"), host_trace(trace_exact)
    del net2
    name = "vit_base_patch16_384"
    net = get_net(name, seed=0)
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, net.cfg.img_size, net.cfg.img_size)).astype(np.float32)
    with S.argmax_trace() as trace_shard:
        q_shard, by_path[SHARD_PATH], _ = run_path(
            SHARD_PATH, sk, net, calib, config=ptq4vit(),
            batch_size=USER_MICRO_BATCH // MESH_WORLD)
    q_shard, trace_shard = qstate_to(q_shard, "cpu"), host_trace(trace_shard)
    classes = net.cfg.num_classes
    del net
    # the single device's tensor-parallel references (and, fused, its
    # launches, which each rank's add q8_epilogue to)
    ref_tp, ref_tp_launches = {}, {}
    for tname, modes in TP_MODES.items():
        tnet = get_net(tname, seed=0)
        x_tp = first_request(tnet.cfg.img_size)[:MESH_TP_IMAGES]
        for mode, int8 in modes.items():
            ev = Evaluator(tnet, qstate_to(qstates[tname], "cuda"),
                           int8=int8)
            _reset(sk, sv)
            ref_tp[tname, mode] = ev.logits(x_tp).cpu()
            torch.cuda.synchronize()
            ref_tp_launches[tname, mode] = by_path[
                f"{tname} single device {mode}, {MESH_TP_IMAGES} images"] = \
                _counts(sk, sv)
            del ev
        del tnet
        torch.cuda.empty_cache()
    labels = ref_tp[name, "fake-quant"].argmax(-1).numpy()
    labels[::2] = (labels[::2] + 1) % classes
    n_correct_ref = int((ref_tp[name, "fake-quant"].argmax(-1).numpy()
                         == labels).sum())

    devices = launch.default_devices(MESH_WORLD)
    backend = launch.choose_backend(devices)
    with tempfile.TemporaryDirectory(prefix="ptq4vit_smoke_mesh_") as tmp:
        job = os.path.join(tmp, "job.pt")
        torch.save({"qstates": {k: qstates[k] for k in BASE},
                    "labels": labels}, job)
        t0 = time.time()
        launch.spawn(mesh_rank, MESH_WORLD, devices=devices, args=(job, tmp),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        ranks_s = time.time() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(MESH_WORLD)]
        t0 = time.time()
        launch.spawn(nccl_rank, 1, devices=["cuda:0"], args=(job, tmp),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        nccl_s = time.time() - t0
        one = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    log(f"[mesh] {MESH_WORLD} ranks, backend {backend}, ranks -> devices "
        f"{[r['device'] for r in ranks]}: {ranks_s:.1f} s with start-up; "
        "seconds by path on rank 0: " + ", ".join(
            f"{k} {v['seconds']:.2f}" for k, v in ranks[0]["paths"].items()))
    summary.update(backend=backend, devices=[r["device"] for r in ranks],
                   ranks_s=ranks_s, nccl_one_rank_s=nccl_s)

    # calibrations: launches and qstates; each rank's shard launches
    # exactly what the single device's path does
    refs = {f"mesh {p} calibration": (
                f"the single device's ({p})", qstates[p], traces[p],
                launches[p]) for p in BASE}
    refs[f"mesh {MESH_EXACT_PATH} calibration"] = (
        "the single device's", q_exact, trace_exact,
        by_path[MESH_EXACT_PATH])
    refs[USER_KEY] = ("one device's on 2-image micro-batches", q_shard,
                      trace_shard, by_path[SHARD_PATH])
    for key, (ref, q_ref, trace_ref, expect) in refs.items():
        for r, res in enumerate(ranks):
            check_exact_launches(f"rank {r} {key}",
                                 res["paths"][key]["launches"], expect)
        summary[key] = check_mesh_qstate(key, ref, q_ref, trace_ref, ranks)
    # the witness: one device on 2-image micro-batches and the mesh at
    # phase 4's micro-batch part from phase 4 at the same picks when a
    # captured gradient's last bits follow the forward's shape
    witness = {}
    for label, q, trace in (
            (SHARD_PATH, q_shard, trace_shard),
            (USER_KEY, ranks[0]["paths"][USER_KEY]["qstate"],
             ranks[0]["paths"][USER_KEY]["trace"])):
        n, total, ties, bad = qstate_diff(qstates[name], traces[name], q,
                                          trace)
        witness[label] = {"slots_differing": n, "ties": ties,
                          "not_ties": bad}
        log(f"[mesh] witness, {label} against phase 4 (4-image "
            f"micro-batches): {n} of {total} slots differ; ties "
            f"{json.dumps(ties)}; not ties {json.dumps(bad)}")
    ops = [sorted({**w["ties"], **w["not_ties"]}) for w in witness.values()]
    log(f"[mesh] witness: the two part from phase 4 at "
        f"{'the same' if ops[0] == ops[1] else 'different'} ops "
        f"({len(ops[0])} and {len(ops[1])})")
    summary["micro-batch witness"] = witness

    # data-parallel serving against phase 7's first request
    for name in BASE:
        key = f"mesh {name} serving"
        ref = served[name]
        for r, res in enumerate(ranks):
            check_exact_launches(f"rank {r} {key}", res["paths"][key][
                "launches"], serve_launches(name))
            got = res["paths"][key]["logits"]
            if not torch.equal(got, ranks[0]["paths"][key]["logits"]):
                raise AssertionError(f"{key}: ranks gathered different "
                                     "logits")
        got = ranks[0]["paths"][key]["logits"].float()
        refl = ref.float()
        diff = int((got != refl).sum())
        log(f"[mesh] {name} serving: {SERVE_BATCH} images over {MESH_WORLD} "
            "ranks, "
            f"{diff} of {got.numel()} logits differ from phase 7's "
            f"(max abs {float((got - refl).abs().max()):.3e})")
        torch.testing.assert_close(got, refl, rtol=1e-5,
                                   atol=1e-5 * float(refl.abs().max()))
        summary[key] = {"elements_differing": diff}

    # tensor-parallel evaluation against the single device's: both int8
    # modes bitwise, fused with the single device's launches plus one
    # q8_epilogue a row-parallel linear on every rank
    for (tname, mode), ref in ref_tp.items():
        key = f"mesh {tname} tensor-parallel {mode}"
        got = ranks[0]["paths"][key]["logits"]
        for r, res in enumerate(ranks):
            if not torch.equal(res["paths"][key]["logits"], got):
                raise AssertionError(f"{key}: ranks differ")
            if mode == "fused":
                expect = dict(ref_tp_launches[tname, mode])
                expect["q8_epilogue"] = TP_EPILOGUES[tname]
                check_exact_launches(f"rank {r} {key}",
                                     res["paths"][key]["launches"], expect)
        diff = int((got != ref).sum())
        cos = float(torch.nn.functional.cosine_similarity(
            got, ref, dim=-1).min())
        same_pred = int((got.argmax(-1) == ref.argmax(-1)).sum())
        launched = {k: v for k, v in ranks[0]["paths"][key][
            "launches"].items() if v}
        log(f"[mesh] {key[5:]}: {MESH_TP_IMAGES} images, model axis "
            f"{MESH_WORLD}: {diff} of {got.numel()} logits differ from the "
            f"single device's, min cosine {cos:.6f}, argmax equal on "
            f"{same_pred} of {MESH_TP_IMAGES}; "
            f"{ranks[0]['paths'][key]['seconds']:.2f} s on rank 0, "
            f"launches a rank {launched}")
        if mode != "fake-quant" and diff:
            raise AssertionError(f"tensor-parallel {mode} logits are not "
                                 "the single device's bitwise")
        if cos < 0.99:
            raise AssertionError(f"{key}: cosine {cos:.4f} < 0.99")
        summary[key] = {"elements_differing": diff, "min_cosine": cos,
                        "launches_a_rank": launched}

    # the one-rank NCCL world
    ref = served["vit_base_patch16_384"]
    check_exact_launches("one-rank NCCL serving", one["launches"],
                         serve_launches("vit_base_patch16_384"))
    diff = int((one["logits"] != ref).sum())
    log(f"[mesh] one-rank world, backend {one['backend']}: ServingEngine("
        f"mesh=) {diff} of {ref.numel()} logits differ from phase 7's; "
        f"Evaluator(mesh=) n_correct {one['n_correct']} (single device "
        f"{n_correct_ref}); {nccl_s:.1f} s with start-up")
    if one["backend"] != "nccl" or diff or one["n_correct"] != n_correct_ref:
        raise AssertionError("the one-rank NCCL world disagrees with the "
                             "single device")
    for r, res in enumerate(ranks):
        for k, v in res["paths"].items():
            by_path[f"{k}, rank {r}"] = v["launches"]
    by_path["mesh vit_base_patch16_384 serving, one-rank NCCL"] = \
        one["launches"]
    summary["wall_s"] = time.time() - t_phase
    log(f"[mesh] phase 11: {summary['wall_s']:.1f} s")
    return by_path, summary


def _leaves(tree):
    """The tensors of a param tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def mesh_only(sk, sv):
    """``--mesh``: phase 11 after the calibrations and the first request
    it reads (phases 4, 5 and 7's)."""
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.calib import search as S
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    qstates, traces, launches, served = {}, {}, {}, {}
    for name in BASE:
        with S.argmax_trace() as trace:
            qstates[name], launches[name], _ = calibrate_and_serve(
                name, name, sk)
        traces[name] = host_trace(trace)
        net = get_net(name, seed=0)
        engine = ServingEngine(net, qstate_to(qstates[name], "cuda"))
        served[name] = engine(first_request(net.cfg.img_size)).cpu()
        del engine, net
        torch.cuda.empty_cache()
    _, summary = mesh_phase(sk, sv, qstates, traces, launches, served)
    print(json.dumps(summary))


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Card check of the port.")
    ap.add_argument("--mesh", action="store_true",
                    help="phase 11 alone, after what it reads")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops import search_kernels as sk

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _, nvcc_s = build.build_all()          # one nvcc per source, together
    for name in build.LIBRARIES:
        build.load(name)
    log(f"[build] {len(build.LIBRARIES)} kernel libraries built in "
        f"{nvcc_s:.1f} s (nvcc, in parallel), {time.time() - t0:.1f} s "
        "with loading")

    if args.mesh:
        mesh_only(sk, sv)
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    stats = kernel_phase(sk, torch.device("cuda"))
    stats.update(serve_kernel_phase(sv, torch.device("cuda")))
    stats.update(window_kernel_phase(sv, torch.device("cuda")))
    # the large shapes after each kernel's phase-3 cases: the first stays
    # its headline
    merge_stats(stats, large_kernel_phase(sk, sv, torch.device("cuda")))
    merge_stats(stats, grid_kernel_phase(sk, sv, torch.device("cuda")))

    from ptq4vit_tpu_torch.calib import search as S
    by_path, summaries, qstates, traces, served = {}, [], {}, {}, {}
    for path, name, qkw in (
            ("vit_base_patch16_384", "vit_base_patch16_384", {}),
            ("swin_base_patch4_window12_384",
             "swin_base_patch4_window12_384", {}),
            ("vit_base_patch16_384 exact", "vit_base_patch16_384",
             {"int8_score": False})):
        # every candidate pick, for phase 11's tie test
        with S.argmax_trace() as trace:
            qstates[path], by_path[path], summary = calibrate_and_serve(
                path, name, sk, **qkw)
        traces[path] = host_trace(trace)
        summaries.append(summary)
    flips = flip_count(inventory("vit_base_patch16_384"),
                       qstates["vit_base_patch16_384"],
                       qstates["vit_base_patch16_384 exact"])
    total = [sum(v[0] for v in flips.values()),
             sum(v[1] for v in flips.values())]
    log("[flips] int8 vs exact scoring, vit_base_patch16_384, 8 images: "
        + json.dumps({"by_op_type": flips, "total": total}))
    for name in BASE:
        launches, summary, (net, qstate, x0, served[name]) = serving_phase(
            sk, sv, name, qstates[name])
        by_path[summary["path"]] = launches
        by_path[summary["relaxed"]["path"]] = summary["relaxed"]["launches"]
        summaries.append(summary)
        if name == "vit_base_patch16_384":
            launches, summary = layout_path(sk, sv, net, qstate, x0[:4])
            by_path.update(launches)
            summaries += summary
        del net, qstate, x0
        torch.cuda.empty_cache()
    launches, summary = window_per_op_path(sk, sv)
    by_path.update(launches)
    summaries.append(summary)
    for path, (launches, summary) in policy_phase(sk).items():
        by_path[path] = launches
        summaries.append(summary)
    with tempfile.TemporaryDirectory(prefix="ptq4vit_smoke_data_") as tmp:
        root = os.path.join(tmp, "imagenet")
        t0 = time.time()
        write_image_folder(root)
        log(f"[data] wrote an ImageFolder of 2 x 2 classes x 24 JPEGs "
            f"(500 x 375 and 375 x 500) in {time.time() - t0:.2f} s")
        for phase in (calibration_surface_phase, drivers_phase):
            launches, summary = phase(sk, sv, root)
            by_path.update(launches)
            summaries.append(summary)
    launches, summary = large_model_phase(
        sk, sv, qstates["swin_base_patch4_window12_384"])
    by_path.update(launches)
    summaries += summary
    launches, summary = grid_phase(sk, sv)
    by_path.update(launches)
    summaries += summary
    launches, summary = mesh_phase(sk, sv, qstates, traces, by_path, served)
    by_path.update(launches)
    summaries.append(summary)
    log("[paths] " + json.dumps({"card": card, "paths": summaries}))

    entries = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(c.get(k, 0) for c in by_path.values()),
                "launches_by_path": {n: c.get(k, 0)
                                     for n, c in by_path.items()},
                "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
                "bound_ms": stats[k]["bound_ms"],
                "bound_by": stats[k]["bound_by"],
                # no PyTorch call computes the sims or the quantized
                # function: the B4 cases carry torch.mm, the serving cases
                # torch._int_mm / SDPA times as context
                "library_ms": None, "cases": stats[k]["cases"]}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
