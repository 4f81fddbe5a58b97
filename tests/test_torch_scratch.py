"""The search kernels' scratch in candidate chunks, and the large models.

  * each wrapper's plain version cut into chunks of candidates
    (``search_kernels.in_chunks``, through the wrapper's ``scratch_bound``)
    equals the whole call bitwise: B1 (plain and twin, one and three row
    blocks), B2 (signed and post-GELU), B3 modes a / b / b_sos, B4w, B4a,
    with P = 7 cut into chunks of 3;
  * a search with a small ``scratch_bound`` picks the same intervals as
    with none, its calls chunked;
  * ``kernel_scratch_bytes`` with a bound: unchanged where the whole call
    fits it (tests/test_torch_swin.py's Swin-B/384 values at 8 images),
    within it at Swin-L/384 with 128 images under PTQ4ViT and BasePTQ;
    ``plan_scratch`` on an 80 GB card's room chunks exactly the ops whose
    whole call does not fit, and every op's search then fits;
  * the planner's MemoryError, naming the op, where one candidate's
    scratch and the op's caches cannot fit, raised before any capture;
  * the large models' registry rows, inventories and op shapes equal the
    JAX package's.

tests/test_torch_large.py calibrates at the large models' widths.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.models import registry as jreg
from ptq4vit_tpu_torch.calib import calibrator as P
from ptq4vit_tpu_torch.calib import search as psearch
from ptq4vit_tpu_torch.calib.calibrator import (kernel_scratch_bytes,
                                                plan_scratch, scratch_terms,
                                                tap_bytes)
from ptq4vit_tpu_torch.configs import base_ptq as pbase_ptq
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.models import MODEL_ZOO, model_config
from ptq4vit_tpu_torch.models.registry import _model_module
from ptq4vit_tpu_torch.ops import search_kernels as K
from ptq4vit_tpu_torch.quant.fakequant import GELU_NEG_CLIP
from tests.torch_port_helpers import TINY, images, jax_net, port_net, shrink

GIB = 1 << 30
NP, CHUNK, Q = 7, 3, 128
LARGE = ("vit_large_patch16_384", "swin_large_patch4_window12_384")


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def grid(base):
    """NP candidates around ``base`` (float32)."""
    return (np.linspace(0.2, 1.2, NP) * base).astype(np.float32)


def linear_inputs(rng, M, ic, oc, postgelu):
    x = rng.standard_normal((M, ic)).astype(np.float32)
    if postgelu:
        x = x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
    w = (rng.standard_normal((oc, ic)) / np.sqrt(ic)).astype(np.float32)
    raw = (x @ w.T).astype(np.float32)
    g = (rng.standard_normal((M, oc)) * 1e-2).astype(np.float32)
    return x, w, raw, g


def linear_case(kname, postgelu=False, n_V=1):
    """(wrapper, args before the candidates, candidates, args after,
    scratch) of a linear kernel at M = 40, ic 48, oc 96."""
    rng = np.random.default_rng(0)
    M, ic, oc = 40, 48, 96
    x, w, raw, g = linear_inputs(rng, M, ic, oc, postgelu)
    a = np.float32((x.max() if postgelu else np.abs(x).max()) / (Q - 0.5))
    a_neg = np.float32(GELU_NEG_CLIP / Q)
    x_lv = np.clip(np.round(x / a), 0 if postgelu else -Q, Q - 1)
    x_neg = np.clip(np.round(x / a_neg), -Q, 0)
    w_int = np.float32(np.abs(w).max() / (Q - 0.5))
    w_lv = np.clip(np.round(w / w_int), -Q, Q - 1)
    if kname in ("b1", "b4w"):
        base = np.abs(w.reshape(n_V, -1)).max(1) / (Q - 0.5)
        cands = t(grid(1.0)[:, None] * base[None].astype(np.float32))
        if n_V == 1:
            cands = cands[:, 0].contiguous()
    else:
        cands = t(grid(a))
    if kname == "b1":
        return (K.linear_w_hessian_sims_i8,
                (t(x_lv, torch.int8), t(x_neg, torch.int8) if postgelu
                 else None, float(a), float(a_neg) if postgelu else None,
                 t(w)), cands, (t(raw), t(g), Q),
                K.linear_w_scratch(M, ic, oc, n_V, postgelu))
    if kname == "b2":
        return (K.linear_a_hessian_sims_i8,
                (t(x), t(w_lv, torch.int8), t(np.full(oc, w_int))), cands,
                (t(raw), t(g), Q, postgelu,
                 GELU_NEG_CLIP / Q if postgelu else 0.0),
                K.linear_a_scratch(M, ic, oc, postgelu))
    if kname == "b4w":
        x_sim = x_lv * a + (x_neg * a_neg if postgelu else 0)
        return (K.linear_w_hessian_sims, (t(x_sim), t(w)), cands,
                (t(raw), t(g), Q), K.linear_w_f32_scratch(M, ic, oc, n_V))
    return (K.linear_a_hessian_sims, (t(x), t(w_lv * w_int)), cands,
            (t(raw), t(g), Q, postgelu,
             GELU_NEG_CLIP / Q if postgelu else 0.0),
            K.linear_a_f32_scratch(M, ic, oc, postgelu))


def matmul_case(mode):
    """B3's arguments at 3 samples, 2 heads, 20 tokens, head dim 16."""
    rng = np.random.default_rng(1)
    S, G, N, hd = 3, 2, 20, 16
    qk = rng.standard_normal((S, G, N, hd)).astype(np.float32)
    kT = rng.standard_normal((S, G, hd, N)).astype(np.float32)
    att = qk @ kT / np.float32(hd ** 0.5)
    att = np.exp(att - att.max(-1, keepdims=True))
    att = (att / att.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((S, G, N, hd)).astype(np.float32)

    def heads_absmax(a):
        return (np.abs(a).max((0, 2, 3)) / (Q - 0.5)).astype(np.float32)
    A, B, cand_src, fix = {"a": (qk, kT, qk, heads_absmax(kT)),
                           "b": (qk, kT, kT, heads_absmax(qk)),
                           "b_sos": (att, v, v, np.ones(G, np.float32))}[mode]
    gr = (rng.standard_normal(A.shape[:3] + B.shape[-1:]) * 1e-2) \
        .astype(np.float32)
    split = np.float32(2.0 ** -6)
    a_int = np.float32(split / np.float32(Q - 1))
    sos = ((float(split), float(a_int), float(1 / np.float32(Q - 1)),
            float(a_int)) if mode == "b_sos" else None)
    cands = t(grid(1.0)[:, None] * heads_absmax(cand_src)[None])
    return (K.matmul_hessian_sims, (t(A), t(B), t(gr)), cands,
            (t(fix), mode, Q, Q, sos),
            K.matmul_scratch(S, G, N, A.shape[-1], B.shape[-1], mode))


CASES = {
    "B1": lambda: linear_case("b1"),
    "B1 twin": lambda: linear_case("b1", postgelu=True),
    "B1 n_V=3": lambda: linear_case("b1", n_V=3),
    "B2": lambda: linear_case("b2"),
    "B2 post-GELU": lambda: linear_case("b2", postgelu=True),
    "B3 a": lambda: matmul_case("a"),
    "B3 b": lambda: matmul_case("b"),
    "B3 b_sos": lambda: matmul_case("b_sos"),
    "B4w": lambda: linear_case("b4w"),
    "B4w n_V=3": lambda: linear_case("b4w", n_V=3),
    "B4a": lambda: linear_case("b4a"),
    "B4a post-GELU": lambda: linear_case("b4a", postgelu=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_call_equals_whole_call(case):
    """The wrapper under a bound of three candidates' scratch cuts its 7
    candidates into 3 + 3 + 1, each chunk its plain version, the sims
    joined in order: bitwise the whole call's, as are in_chunks over the
    plain version and the plain version itself."""
    fn, pre, cands, post, scratch = CASES[case]()
    fixed, per = scratch
    bound = fixed + CHUNK * per
    assert K.candidate_chunk(NP, scratch, bound) == CHUNK
    assert K.candidate_chunk(NP, scratch, bound - 1) == CHUNK - 1
    assert K.candidate_chunk(NP, scratch, None) == NP
    assert K.candidate_chunk(NP, scratch, fixed + NP * per) == NP
    whole = fn(*pre, cands, *post)
    K.reset_launch_counts()
    chunked = fn(*pre, cands, *post, scratch_bound=bound)
    assert K.chunked_calls() == 1
    assert chunked.shape == whole.shape == cands.shape
    assert torch.equal(chunked, whole)
    ref = getattr(K, fn.__name__ + "_ref",
                  K.matmul_hessian_sims_ref)
    assert torch.equal(K.in_chunks(lambda c: ref(*pre, c, *post), cands,
                                   CHUNK), ref(*pre, cands, *post))
    assert K.chunked_calls() == 2
    assert torch.equal(fn(*pre, cands, *post,
                          scratch_bound=fixed + NP * per), whole)
    assert K.chunked_calls() == 2          # the whole call fits: one call
    with pytest.raises(ValueError, match="holds no candidate"):
        fn(*pre, cands, *post, scratch_bound=fixed + per - 1)


@pytest.fixture(scope="module")
def tiny_caps():
    jnet = jax_net(TINY)
    caps = jcapture(jnet, images(4, 32), batch_size=2, need_grad=True,
                    probe_sigma=1e-1)
    return jnet, jax.tree.map(np.asarray, jnet.params), caps


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "exact"])
def test_search_in_chunks_picks_the_same_intervals(tiny_caps, int8):
    """search_linear / search_matmul with a scratch bound of about two
    candidates' level buffers pick the very intervals of the unbounded
    search, through the kernels' plain versions (B1 / B2 / B3 under int8
    scoring, B4w / B4a under exact), and chunk every kernel call."""
    from tests.test_torch_search import port_cap
    jnet, params, caps = tiny_caps
    cfg = shrink(pptq4vit())
    for name, mtype in jnet.op_inventory:
        if mtype == "qconv" or ("qmatmul" in mtype and not int8):
            continue
        pol = cfg.op_policy(mtype)
        cap = port_cap(caps[name], with_out=False)
        info = port_net(jnet).op_shapes[name]
        terms = scratch_terms(info, 4, pol)
        bound = max(f + 2 * p for f, p, _ in terms)
        out = []
        K.reset_launch_counts()
        for sb in (None, bound):
            if "qmatmul" in mtype:
                out.append(psearch.search_matmul(
                    cap, pol, int8_score=True, use_kernels=True,
                    scratch_bound=sb))
            else:
                w, b = (torch.from_numpy(np.array(a))
                        for a in P.params_for_op(params, name))
                out.append(psearch.search_linear(
                    w, b, cap, pol, int8_score=int8, use_kernels=True,
                    scratch_bound=sb))
        assert K.chunked_calls() >= 1, name
        for f in dataclasses.fields(out[0]):
            v0, v1 = getattr(out[0], f.name), getattr(out[1], f.name)
            if torch.is_tensor(v0):
                assert torch.equal(v0, v1), (name, f.name)
            else:
                assert v0 == v1


def swin_b384():
    cfg = model_config("swin_base_patch4_window12_384")
    return pptq4vit(), _model_module(cfg).op_shapes(cfg), \
        dict(_model_module(cfg).op_inventory(cfg))


def test_kernel_scratch_bytes_unchanged_where_the_call_fits():
    """tests/test_torch_swin.py's Swin-B/384 values at 8 images, under no
    bound and under one that the whole call fits."""
    pol, shapes, inv = swin_b384()
    fc2 = "layers.0.blocks.0.mlp.fc2"
    mm2 = "layers.0.blocks.0.attn.matmul2"
    M, Z = 9216 * 8, 4 * 64 * 8
    want = {fc2: 100 * M * 512 + M * 512 + 4 * 128 * 512,
            mm2: 2 * Z * 144 * 160 + 100 * Z * 32 * 160
            + 4 * 100 * 4 * (64 * 8) * 3 * 1 * 8}
    for op, v in want.items():
        p = pol.op_policy(inv[op])
        for bound in (None, v + GIB, 64 * GIB):
            assert kernel_scratch_bytes(shapes[op], 8, p, bound) == v
    for op, info in shapes.items():
        p = pol.op_policy(inv[op])
        assert kernel_scratch_bytes(info, 8, p, 64 * GIB) == \
            kernel_scratch_bytes(info, 8, p)


def large_net(name):
    cfg = model_config(name)
    mod = _model_module(cfg)
    return mod.op_shapes(cfg), mod.op_inventory(cfg)


@pytest.mark.parametrize("config", ["PTQ4ViT", "BasePTQ"])
def test_kernel_scratch_within_the_bound_at_swin_l384_128(config):
    """Swin-L/384 at 128 images: one call of stage 1's fc2 (PTQ4ViT) or
    matmul2 (BasePTQ) takes more than an 80 GB card; under a bound each
    kernel's chunks stay within it (the fp32 operand B4w / B4a take
    beside them), and the scratch shrinks with the bound."""
    cfg = pptq4vit() if config == "PTQ4ViT" else pbase_ptq()
    shapes, inv = large_net("swin_large_patch4_window12_384")
    worst = max(kernel_scratch_bytes(shapes[n], 128, cfg.op_policy(tp))
                for n, tp in inv)
    assert worst > 80 * GIB
    for bound in (8 * GIB, 24 * GIB):
        for n, tp in inv:
            pol = cfg.op_policy(tp)
            got = kernel_scratch_bytes(shapes[n], 128, pol, bound)
            assert got <= kernel_scratch_bytes(shapes[n], 128, pol)
            terms = scratch_terms(shapes[n], 128, pol)
            for f, p, _ in terms:
                c = K.candidate_chunk(pol.eq_n, (f, p), bound)
                assert 1 <= c <= pol.eq_n and f + c * p <= bound
            assert got <= bound + max((e for *_, e in terms), default=0)


@pytest.mark.parametrize("name", LARGE + ("swin_base_patch4_window12_384",))
@pytest.mark.parametrize("config", ["PTQ4ViT", "BasePTQ"])
def test_plan_scratch_on_an_80gb_card(name, config):
    """plan_scratch with 85% of an H100's 79 GiB: the ops whose whole call
    (beside working set, caches, search budget and capture reserve) does
    not fit are chunked, every other op keeps its whole call, and every
    op's search then fits beside its caches.  At 128 images Swin-L/384
    chunks under both configs, ViT-L/384 and Swin-B/384 under BasePTQ; at
    32 images nothing does."""
    cfg = pptq4vit() if config == "PTQ4ViT" else pbase_ptq()
    shapes, inv = large_net(name)
    policies = {n: cfg.op_policy(tp) for n, tp in inv}
    room, fixed = int(0.85 * 79 * GIB), psearch.DEFAULT_BUDGET + GIB
    net = type("N", (), {"op_shapes": shapes})()
    for n_img in (32, 128):
        work = tap_bytes(net, n_img, True, True, 4)
        caches = tap_bytes(net, n_img, True, False, 2)
        bounds, needs = plan_scratch(shapes, n_img, policies, work, caches,
                                     room, fixed)
        for op, pol in policies.items():
            whole = kernel_scratch_bytes(shapes[op], n_img, pol)
            base = work[op] + fixed + caches[op]
            assert (op in bounds) == (base + whole > room), op
            got = kernel_scratch_bytes(shapes[op], n_img, pol,
                                       bounds.get(op))
            assert base + got <= room and needs[op] == work[op] + fixed + got
        chunked = n_img == 128 and (config == "BasePTQ"
                                    or name.startswith("swin_large"))
        assert bool(bounds) == chunked


def test_planner_names_the_op_that_cannot_fit():
    """Where one candidate's scratch, the op's caches and working set do
    not fit the room, plan_scratch raises a MemoryError naming the op and
    its bytes."""
    shapes, inv = large_net("swin_large_patch4_window12_384")
    cfg = pptq4vit()
    policies = {n: cfg.op_policy(tp) for n, tp in inv}
    net = type("N", (), {"op_shapes": shapes})()
    work = tap_bytes(net, 128, True, True, 4)
    caches = tap_bytes(net, 128, True, False, 2)
    with pytest.raises(MemoryError, match=r"layers\.0\.blocks\.0\.attn\."
                       r"matmul1: one candidate's kernel scratch \(\d+ "
                       r"bytes\), its caches \(\d+ bytes\)"):
        plan_scratch(shapes, 128, policies, work, caches, 12 * GIB, 3 * GIB)


@pytest.mark.parametrize("sequential", [False, True])
def test_calibrator_raises_before_any_capture(monkeypatch, sequential):
    """The calibrator plans on the card's free memory before its first
    capture: 256 MiB free cannot hold the tiny ViT's first op, and the
    error names it.  Fakes of torch.cuda's memory calls stand in for the
    card."""
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    c = P.HessianQuantCalibrator(pnet, shrink(pptq4vit()), images(4, 32),
                                 sequential=sequential, device="cpu")
    c.device = torch.device("cuda")      # the planner's card branch
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (256 << 20, 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)

    def no_capture(*a, **kw):
        raise AssertionError("captured before planning")
    monkeypatch.setattr(P, "capture", no_capture)
    first = pnet.op_inventory[0][0]
    with pytest.raises(MemoryError, match=first):
        c.batching_quant_calib()


@pytest.mark.parametrize("tight,short", [(False, True), (True, False),
                                         (True, True)])
def test_capture_releases_cached_blocks_only_where_memory_is_short(
        monkeypatch, tight, short):
    """Before a capture the caching allocator's free blocks go back to the
    driver only in a tight plan (the caches in more than one capture group,
    or an op chunked) and only where the driver's free memory cannot hold
    the group's caches and its largest search.  Where the whole job fits
    in one group, as the headline job does, the blocks stay cached, as
    before the planner.  Fakes of torch.cuda's memory calls and of the
    capture stand in for the card."""
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    c = P.HessianQuantCalibrator(pnet, shrink(pptq4vit()), images(4, 32),
                                 device="cpu")
    c.device = torch.device("cuda")      # the planner's card branch
    card = {"free": 60 * GIB, "released": 0}

    def empty_cache():
        card["released"] += 1
    for fn, fake in (("mem_get_info", lambda d=None: (card["free"], 80 * GIB)),
                     ("memory_reserved", lambda d=None: 0),
                     ("memory_allocated", lambda d=None: 0),
                     ("max_memory_allocated", lambda d=None: 0),
                     ("synchronize", lambda d=None: None),
                     ("empty_cache", empty_cache)):
        monkeypatch.setattr(torch.cuda, fn, fake)
    monkeypatch.setattr(P, "capture", lambda *a, **kw: {})
    policies = {n: c.cfg.op_policy(t) for n, t in c.wrapped_modules}
    c._plan_search(True, policies)
    assert not c._tight
    caches, needs = c._op_cache_bytes, c.search_needs
    if tight:
        # a room that holds each op's search beside its caches, not every
        # cache beside the largest search
        room = max(needs.values()) + max(caches.values()) + \
            (sum(caches.values()) - max(caches.values())) // 2
        card["free"] = int(room / 0.85) + 1
        c._plan_search(True, policies)
        assert c._tight and not c.scratch_bounds
    ops = [n for n, _ in c.wrapped_modules[:3]]
    need = sum(caches[op] for op in ops) + max(needs[op] for op in ops)
    card["free"] = need - 1 if short else 60 * GIB
    c._capture(ops, True)
    assert card["released"] == int(tight and short)


@pytest.mark.parametrize("name", LARGE)
def test_large_registry_rows_match_jax(name):
    """The large models' rows, op inventories and op shapes equal the JAX
    package's: ViT-L/384 (embed 1024, 24 blocks, 16 heads, N = 577: 97
    linears, 48 matmuls), Swin-L/384 (embed 192, depths 2 / 2 / 18 / 2,
    heads 6 / 12 / 24 / 48, window 12: 24 blocks, 3 patch merges, the
    head)."""
    assert MODEL_ZOO[name] == jreg.MODEL_ZOO[name]
    cfg, jcfg = model_config(name), jreg.model_config(name)
    mod = _model_module(cfg)
    jmod = jreg.vit_mod if name.startswith("vit") else jreg.swin_mod
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert mod.op_inventory(cfg) == jmod.op_inventory(jcfg)
    assert mod.op_shapes(cfg) == jmod.op_shapes(jcfg)
    kinds = [tp for _, tp in mod.op_inventory(cfg)]
    if name.startswith("vit"):
        assert (cfg.embed_dim, cfg.depth, cfg.num_heads) == (1024, 24, 16)
        assert sum(tp.startswith("qlinear") for tp in kinds) == 97
        assert sum(tp.startswith("qmatmul") for tp in kinds) == 48
    else:
        assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size) \
            == (192, (2, 2, 18, 2), (6, 12, 24, 48), 12)
        assert sum(tp.startswith("qlinear") for tp in kinds) == \
            24 * 4 + 3 + 1
        assert sum(tp.startswith("qmatmul") for tp in kinds) == 48
