"""Every registry row's kernel plans at full width, on the CPU (arithmetic
only: no kernel runs).

  * each op shape of each of the 21 models has a plan in every wrapper its
    path takes: B1 / B2 (``linear_plan``) and B4w / B4a (``fp32_plan``) at
    each linear, B3 / B3f (``matmul_plan`` in modes a, b and b_sos, and
    ``mm_fold_factor``) at each attention matmul, with 32 and 128
    calibration images; B6 / B10 / B11 (``q8_plan``) at each served linear
    and B7 / B9 (``attn_plan``) at each attention, with 32 images a
    request;
  * ``plan_scratch`` plans 32 and 128 images under PTQ4ViT and BasePTQ
    within 85% of an H100's 79.1 GiB, with no MemoryError, every op's
    search beside its caches within that room, and no op chunked at 32
    images;
  * chip_smoke.py's launch counts (phase 13), computed from the inventory
    and the head fold, equal a hand count: Swin-T's matmuls run B3 in
    stage 1's two blocks (3 heads) and B3f in the other ten.
"""
import importlib.util
import os

import pytest

from ptq4vit_tpu_torch.calib import search as psearch
from ptq4vit_tpu_torch.calib.calibrator import (kernel_scratch_bytes,
                                                plan_scratch, tap_bytes)
from ptq4vit_tpu_torch.configs import base_ptq, ptq4vit
from ptq4vit_tpu_torch.models import MODEL_ZOO, model_config
from ptq4vit_tpu_torch.models.registry import _model_module
from ptq4vit_tpu_torch.models.swin import SwinConfig
from ptq4vit_tpu_torch.ops import int8_serve as V
from ptq4vit_tpu_torch.ops import search_kernels as K

GIB = 1 << 30
CARD_GIB = 79.1           # an H100 80GB HBM3's memory, as torch reads it
ROOM = int(0.85 * CARD_GIB * GIB)
NAMES = sorted(MODEL_ZOO)
P = 100                          # eq_n: candidates a call
SERVE_BATCH = 32


def zoo(name):
    cfg = model_config(name)
    mod = _model_module(cfg)
    return cfg, mod.op_shapes(cfg), mod.op_inventory(cfg)


def chip_smoke():
    """chip_smoke.py as a module (its launch counts)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_plans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_registry_has_21_rows():
    assert len(NAMES) == 21


@pytest.mark.parametrize("name", NAMES)
def test_search_plans_at_full_width(name):
    """Every linear has a B1 / B2 / B4w / B4a plan and every attention
    matmul a B3 / B3f plan in each mode, at 32 and 128 images, within a
    block's shared memory; the matmuls fold as the JAX function would
    (``mm_fold_factor``: 1 or a head count divisor)."""
    _, shapes, inv = zoo(name)
    pol = ptq4vit()
    for op, mtype in inv:
        info = shapes[op]
        for n_img in (32, 128):
            if info["kind"] == "linear":
                M, K_, N = (info["tokens"] * n_img, info["in_features"],
                            info["out_features"])
                n_V = pol.op_policy(mtype).n_V
                for kind in ("w", "a"):
                    for twin in (False, True):
                        lp = K.linear_plan(kind, M, N, K_, P, n_V, twin)
                        assert 2 <= lp.stages and lp.smem <= K.LQ_BLOCK_SMEM
                        fp = K.fp32_plan(kind, M, N, K_, P, twin)
                        assert fp.groups * fp.pc >= P
                        assert fp.smem <= K.LQ_BLOCK_SMEM
            elif info["kind"] == "matmul":
                S = info.get("windows", 1) * n_img
                G, R, Ci, Co = (info["heads"], info["rows"], info["inner"],
                                info["cols"])
                for mode in ("a", "b", "b_sos"):
                    mp = K.matmul_plan(S, G, R, Ci, Co, P, mode)
                    assert mp.per_sm >= 1 and mp.smem <= K.SMEM_LIMIT
                    assert mp.col_tiles * mp.width >= Co
                    assert mp.row_tiles * K.MM_ROWS >= R
                fold = K.mm_fold_factor(G, Ci, Co)
                assert fold == 1 or G % fold == 0


@pytest.mark.parametrize("name", NAMES)
def test_serving_plans_at_full_width(name):
    """Each served linear has a q8_plan in the mode the fused path gives
    it, and each attention an attn_plan, with SERVE_BATCH images: ViT /
    DeiT qkv (LN, float in), proj (int8 in), fc1 (float in), fc2 (twin
    int8 in), the head(s); Swin B10 (qkv over the window grid), B11, fc1,
    fc2, the reductions and the head."""
    cfg, shapes, inv = zoo(name)
    modes = {"qlinear_qkv": "f", "qlinear_proj": "q8", "qlinear_MLP_1": "f",
             "qlinear_MLP_2": "q8twin", "qlinear_classifier": "f",
             "qlinear_reduction": "f"}
    attn = set()
    for op, mtype in inv:
        info = shapes[op]
        if info["kind"] == "linear":
            M = info["tokens"] * SERVE_BATCH
            plan = V.q8_plan(M, info["out_features"], modes[mtype],
                             mtype in ("qlinear_proj", "qlinear_MLP_2"))
            assert plan.blocks >= 1 and plan.smem <= K.SMEM_LIMIT
            assert plan.row_tiles * V.Q_ROWS >= M
        elif mtype == "qmatmul_qk":
            attn.add((info["cols"], info["inner"]))
    assert attn
    for N, hd in attn:
        ap = V.attn_plan(N, hd)
        assert ap.keys >= N and ap.hdp >= hd and ap.smem <= K.SMEM_LIMIT
    if isinstance(cfg, SwinConfig):
        # window 7 at 224 px: N = 49 keys padded to 64, parked logits
        assert {N for N, _ in attn} == {cfg.window_size ** 2}
        if cfg.window_size == 7:
            assert V.attn_plan(49, 32)[:6] == (32, 64, 48, 80, True, 4)


@pytest.mark.parametrize("config", ["PTQ4ViT", "BasePTQ"])
@pytest.mark.parametrize("name", NAMES)
def test_plan_scratch_on_the_card_at_32_and_128(name, config):
    """plan_scratch at 32 and 128 images within 85% of 79.1 GiB: no
    MemoryError, every op's search needs and its caches within the room
    (with its chunk bound where it has one), nothing chunked at 32
    images; at 128 images only the /384 models' BasePTQ and Swin-L/384
    chunk (tests/test_torch_scratch.py's rows)."""
    cfg = ptq4vit() if config == "PTQ4ViT" else base_ptq()
    _, shapes, inv = zoo(name)
    policies = {n: cfg.op_policy(tp) for n, tp in inv}
    fixed = psearch.DEFAULT_BUDGET + GIB
    net = type("N", (), {"op_shapes": shapes})()
    for n_img in (32, 128):
        work = tap_bytes(net, n_img, True, True, 4)
        caches = tap_bytes(net, n_img, True, False, 2)
        bounds, needs = plan_scratch(shapes, n_img, policies, work, caches,
                                     ROOM, fixed)
        for op, pol in policies.items():
            assert needs[op] + caches[op] <= ROOM, op
            assert needs[op] == work[op] + fixed + kernel_scratch_bytes(
                shapes[op], n_img, pol, bounds.get(op))
        if n_img == 32:
            assert not bounds
        elif bounds:
            assert name.endswith("_384") and (
                config == "BasePTQ" or name.startswith("swin_large"))


def test_phase_13_launch_counts_equal_a_hand_count():
    """chip_smoke.py's search launches, computed from the op inventory and
    ``mm_fold_factor``, against a hand count.  Swin-T (depths 2 / 2 / 6 /
    2, heads 3 / 6 / 12 / 24): 52 linears (48 in the blocks, 3
    reductions, the head) launch B1 and B2 once a round; each block's
    matmul1 twice a round (A side, B side) and matmul2 once (its SoS split
    search is plain PyTorch), 3 launches a block a round -- B3 in stage
    1's 2 blocks (fold 1 at 3 heads), B3f in the other 10 (folds 2, 4, 4);
    3 rounds.  ViT-B/384: 49 linears, 12 blocks on B3 (108 for its 24
    matmuls, phases 4-5).  ViT-S/32 folds its 6 heads at N = 50 by 2, so
    its 12 blocks run B3f."""
    cs = chip_smoke()
    rounds = 3
    b1, b2 = "linear_w_hessian_sims_i8", "linear_a_hessian_sims_i8"
    b3, b3f = "matmul_hessian_sims_b3", "matmul_hessian_sims_b3f"
    zero = dict.fromkeys(cs.INT8, 0)
    assert cs.model_launches("swin_tiny_patch4_window7_224") == dict(
        zero, **{b1: 52 * rounds, b2: 52 * rounds, b3: 2 * 3 * rounds,
                 b3f: 10 * 3 * rounds})
    assert cs.model_launches("vit_base_patch16_384") == dict(
        zero, **{b1: 147, b2: 147, b3: 108})
    assert cs.model_launches("vit_small_patch32_224") == dict(
        zero, **{b1: 147, b2: 147, b3f: 108})
    # the distilled head is a searched linear too
    assert cs.model_launches("deit_small_distilled_patch16_224") == dict(
        zero, **{b1: 150, b2: 150, b3: 108})
    for name in cs.GRID:
        n = cs.model_launches(name)
        assert n[b1] == n[b2] > 0 and n[b3] + n[b3f] > 0


def test_serve_launches_equal_a_hand_count():
    """chip_smoke.py's serving launches from the config against a hand
    count: a ViT block runs B6 four times (qkv, proj, fc1, fc2) and B7
    once, plus B6 for the head (both heads when distilled); a Swin block
    runs B10, B9, B11 and B6 twice (fc1, fc2), plus B6 for each patch
    merge and the head.  Relaxed: qkv (B10), fc1 and the attention take
    the relaxed variants, the rest the exact kernels."""
    cs = chip_smoke()
    assert cs.serve_launches("vit_base_patch16_384") == {
        "q8_linear": 49, "fused_attention_qkv": 12}
    assert cs.serve_launches("vit_base_patch16_384", True) == {
        "q8_linear": 25, "q8_linear_relaxed": 24,
        "fused_attention_qkv_relaxed": 12}
    assert cs.serve_launches("swin_base_patch4_window12_384") == {
        "q8_linear": 52, "fused_window_attention_qkv": 24, "q8_win_qkv": 24,
        "q8_win_proj": 24}
    assert cs.serve_launches("swin_base_patch4_window12_384", True) == {
        "q8_linear": 28, "q8_linear_relaxed": 24,
        "fused_window_attention_qkv_relaxed": 24, "q8_win_qkv_relaxed": 24,
        "q8_win_proj": 24}
    assert cs.serve_launches("vit_large_patch16_384") == {
        "q8_linear": 97, "fused_attention_qkv": 24}
    assert cs.serve_launches("deit_small_distilled_patch16_224") == {
        "q8_linear": 4 * 12 + 2, "fused_attention_qkv": 12}
    assert cs.serve_launches("deit_small_distilled_patch16_224", True) == {
        "q8_linear": 2 * 12 + 2, "q8_linear_relaxed": 24,
        "fused_attention_qkv_relaxed": 12}
    assert cs.serve_launches("swin_tiny_patch4_window7_224") == {
        "q8_linear": 2 * 12 + 3 + 1, "fused_window_attention_qkv": 12,
        "q8_win_qkv": 12, "q8_win_proj": 12}
