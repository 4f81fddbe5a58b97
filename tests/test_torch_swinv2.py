"""Swin Transformer V2 in the port, held to the plain float32 reference
``tests/plain_swinv2.py`` on seeded random weights at a tiny size: the
float forward, the position-bias network, the fake-quant forward under a
calibrated qstate, the capture of every op kind, a whole ``quantize()``
job against the reference search, the fused serving engine on the
kernels' plain versions, and (``-m cuda``, on the card) the V2 serving
kernels against their plain versions.

The tiny V2 (64 px, patch 4, embed 32, depths (2, 2, 2), heads (2, 4, 8),
window 8, pretrained windows (4, 4, 2)) has a shifted stage (16 x 16
tokens in four windows of 64), a one-window stage (8 x 8) and a stage
whose window is clamped to its 4 x 4 map.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference import calib as ref_calib
from benchmark.reference.models import op_kinds
from ptq4vit_tpu_torch import ServingEngine, quantize
from ptq4vit_tpu_torch.configs import ptq4vit
from ptq4vit_tpu_torch.models import registry, swinv2
from ptq4vit_tpu_torch.ops import int8_serve as sv
import plain_swinv2 as plain  # tests/, on sys.path under pytest

TINY = dict(img_size=64, patch_size=4, embed_dim=32, depths=(2, 2, 2),
            num_heads=(2, 4, 8), window_size=8,
            pretrained_window_sizes=(4, 4, 2), mlp_ratio=4.0,
            num_classes=10, ln_eps=1e-5, in_chans=3)
CFG = swinv2.SwinV2Config(name="tiny_swinv2", **TINY)
KINDS = op_kinds(dict(TINY, kind="swinv2"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_params(seed=0, clamped=True):
    """The port's init, with every bias, LayerNorm and CPB leaf drawn
    (timm's init leaves them constant) and the k third of each qkv bias
    zero; the logit scales near timm's ln 10, and with ``clamped`` one
    head's above ln 100, where τ clamps."""
    params = swinv2.init_params(CFG, np.random.default_rng(seed))
    g = torch.Generator().manual_seed(seed + 1)

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                if torch.is_tensor(v):
                    node[k] = draw(v, path + (k,))
                else:
                    walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    def draw(v, path):
        r = torch.randn(v.shape, generator=g)
        if path[-1] == "logit_scale":
            out = math.log(10.0) + 0.2 * r
            if clamped:
                out.view(-1)[0] = 5.0
            return out
        if path[-1] == "bias":
            out = 0.1 * r
            if path[-2] == "qkv":
                c = v.numel() // 3
                out[c:2 * c] = 0.0
            return out
        if path[-2:] in (("norm1", "weight"), ("norm2", "weight"),
                         ("norm", "weight")):
            return 1.0 + 0.1 * r
        return v
    walk(params)
    return params


def images(n=2, seed=3):
    return torch.randn((n, 3, 64, 64),
                       generator=torch.Generator().manual_seed(seed))


def net_of(params):
    return registry.net_from_config(CFG, params)


def plain_qstate(qstate):
    """The port's qstate as the plain reference's {op: intervals}."""
    out = {}
    for name, qp in qstate.items():
        if qp is None:
            continue
        kind = type(qp).__name__
        if kind == "ConvQP":
            out[name] = {"w": qp.w_interval.reshape(-1), "w_qmax": qp.w_qmax,
                         "a": (qp.a_interval.reshape(()) if qp.a_bit < 32
                               and qp.a_interval is not None else None),
                         "a_qmax": qp.a_qmax}
        elif kind == "LinearQP":
            out[name] = {"w": qp.w_interval.reshape(-1), "w_qmax": qp.w_qmax,
                         "a": qp.a_interval.reshape(()), "a_qmax": qp.a_qmax,
                         "a_neg": (None if qp.a_neg_interval is None
                                   else qp.a_neg_interval.reshape(()))}
        else:
            out[name] = {"b": qp.B_interval.reshape(-1), "b_qmax": qp.B_qmax,
                         "a_qmax": qp.A_qmax,
                         "split": (None if qp.split is None
                                   else qp.split.reshape(())),
                         "a": (None if qp.split is not None
                               else qp.A_interval.reshape(-1))}
    return out


def small_policy():
    cfg = ptq4vit()
    for k in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
              cfg.ptqsl_matmul_kwargs):
        k["eq_n"], k["search_round"] = 8, 3
    return cfg


@pytest.fixture(scope="module")
def calibrated():
    """A tiny V2 calibrated by the port on 8 images (float32 caches); τ
    near timm's 10 (a head at τ = 100 multiplies a one-level move of q̂·k̂
    a hundredfold, which the engine's comparison below could not
    tell from a fault)."""
    params = make_params(0, clamped=False)
    x = images(8, seed=5)
    probe = torch.randn((8, 10), generator=torch.Generator().manual_seed(6))
    net, qstate = quantize(net_of(params), x.numpy(), config=small_policy(),
                           batch_size=4, device="cpu",
                           probe_u=probe.numpy(), cache_dtype="float32")
    return params, x, probe, net, qstate


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_registry_row_and_config():
    z = registry.MODEL_ZOO["swinv2_base_window12to24_192to384"]
    cfg = registry.model_config("swinv2_base_window12to24_192to384")
    assert isinstance(cfg, swinv2.SwinV2Config) and z["kind"] == "swinv2"
    assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size,
            cfg.pretrained_window_sizes, cfg.img_size) == (
        128, (2, 2, 18, 2), (4, 8, 16, 32), 24, (12, 12, 12, 6), 384)
    # stage 3's 24 x 24 map is one window, stage 4 clamps the window to 12
    assert [cfg.block_geometry(i, 1) for i in range(4)] == [
        (24, 12), (24, 12), (24, 0), (12, 0)]
    shapes = swinv2.op_shapes(cfg)
    assert shapes["layers.0.blocks.1.attn.matmul1"] == {
        "kind": "matmul", "heads": 4, "rows": 576, "inner": 32, "cols": 576,
        "windows": 16}
    assert registry._model_module(cfg) is swinv2


def test_float_forward_is_the_plain_reference():
    params = make_params(1)
    x = images(2)
    with torch.no_grad():
        ours = net_of(params).apply(x)
        ref = plain.forward(params, x, dict(TINY))
    assert rel_err(ours, ref) < 1e-5


@pytest.mark.parametrize("ws,pws", [(8, 4), (4, 2), (8, 0)])
def test_cpb_table_is_the_closed_form(ws, pws):
    """The position bias against 16 σ(MLP(Δ̂))[index] written out for each
    pair of positions in float64, with Δ̂ = sign(Δ) log2(1 + |8 Δ / (W_pre
    - 1)|) / 3."""
    attn = make_params(2)["layers"][0]["blocks"][0]["attn"]
    w0 = attn["cpb_mlp"]["0"]["weight"].double()
    b0 = attn["cpb_mlp"]["0"]["bias"].double()
    w2 = attn["cpb_mlp"]["2"]["weight"].double()
    wp = pws if pws > 0 else ws
    pos = [(i, j) for i in range(ws) for j in range(ws)]

    def norm(dl):
        t = 8.0 * dl / (wp - 1)
        return math.copysign(math.log2(1 + abs(t)) / 3.0, t) if t else 0.0
    coords = torch.tensor([[norm(p[0] - q[0]), norm(p[1] - q[1])]
                           for p in pos for q in pos], dtype=torch.float64)
    mlp = torch.relu(coords @ w0.t() + b0) @ w2.t()
    want = (16 * torch.sigmoid(mlp)).reshape(ws * ws, ws * ws, -1) \
        .permute(2, 0, 1)
    ours = swinv2.cpb_bias(attn, ws, pws)
    assert ours.dtype == torch.float32
    assert float((ours.double() - want).abs().max()) < 1e-5
    assert torch.equal(ours, plain.cpb_bias(attn, ws, pws))


def test_fake_quant_forward_under_one_qstate(calibrated):
    params, _, _, net, qstate = calibrated
    x = images(4, seed=9)
    with torch.no_grad():
        ours = net.apply(x, qstate=qstate)
        ref = plain.forward(params, x, dict(TINY),
                            plain.Ops(plain_qstate(qstate)))
    assert rel_err(ours, ref) < 1e-4


@pytest.mark.parametrize("kind", ["conv", "qkv", "matmul", "sos", "linear",
                                  "postgelu"])
def test_capture_of_each_op_kind(kind):
    """Inputs, outputs and probe gradients of every op of the kind, as
    the port's forward taps them (``capture=True`` with zero probes)."""
    params = make_params(3)
    x = images(2, seed=4)
    u = torch.randn((2, 10), generator=torch.Generator().manual_seed(7))
    _, ref = plain.capture(params, x, dict(TINY), u)
    net = net_of(params)
    with torch.no_grad():
        logits, taps = net.apply(x, capture=True)
        target = torch.softmax(logits + 1e-3 * u, -1)
    eps = {n: torch.zeros_like(t["out"], requires_grad=True)
           for n, t in taps.items()}
    with torch.enable_grad():
        logits, taps = net.apply(x, capture=True, eps=eps)
        logp = torch.log_softmax(logits, -1)
        loss = torch.sum(target * (torch.log(target) - logp)) / 2
        grads = dict(zip(eps, torch.autograd.grad(loss, list(eps.values()))))
    names = [n for n, k in KINDS.items() if k == kind]
    assert names
    for n in names:
        for key in ("x", "a", "b", "out"):
            if key in ref[n]:
                assert rel_err(taps[n][key].detach(), ref[n][key]) < 1e-5, \
                    (n, key)
        assert rel_err(grads[n], ref[n]["g"]) < 1e-4, n


def test_quantize_job_against_the_reference_search(calibrated):
    """One op of each kind in each stage, the patch embedding, a
    reduction and the head, searched by the benchmark's plain PTQ4ViT
    search on the plain reference's capture: the port's intervals are
    within the calibration cells' limits (gap 0.02, moved 0.05)."""
    params, x, probe, _, qstate = calibrated
    _, caps = plain.capture(params, x, dict(TINY), probe)
    mix = {"eq_n": 8, "search_round": 3}
    pol = ref_calib.Policy(mix)
    pick = {"patch_embed.proj", "head", "layers.1.downsample.reduction"}
    for i in range(len(TINY["depths"])):
        for k in ("qkv", "matmul", "sos", "linear", "postgelu"):
            pick.add(next(n for n, kk in KINDS.items()
                          if kk == k and n.startswith(f"layers.{i}.")))
    kinds = {n: KINDS[n] for n in KINDS if n in pick}
    caches = {n: {k: v for k, v in caps[n].items() if k != "out"}
              for n in kinds}
    reference = {n: ref_calib.search_op(k, caches[n], params, n, pol,
                                        torch.float32)
                 for n, k in kinds.items()}
    program = {n: plain_intervals(qstate[n]) for n in kinds}
    numbers, worst = ref_calib.judge(kinds, caches, params, pol, program,
                                     reference)
    assert numbers["gap"] <= 0.02 and numbers["moved"] <= 0.05, \
        (numbers, worst)


def plain_intervals(qp):
    from benchmark.model import plain_intervals as pi
    return pi(qp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_engine_on_the_plain_kernels(calibrated, dtype):
    """The int8 engine on the CPU (the kernels' plain versions) against the
    plain fake-quant forward.  The two differ by levels that flip where
    the int8 products' exact sums and the float products round a value to
    either side of a level boundary, compounded through the tiny net's 40
    quantizers: the exact per-op int8 path (``int8=True``) itself reads
    2-3% of the largest logit here, and the float32 engine as much
    (within 5%).  In bfloat16 the residual stream, biases and LayerNorm
    weights are rounded to 8 bits too, which moves a near-maximal input
    by a quarter of a level: within 8%."""
    params, _, _, net, qstate = calibrated
    x = images(4, seed=11)
    eng = ServingEngine(net, qstate, device="cpu", compute_dtype=dtype)
    swinv2.reset_cpb_counts()
    with torch.no_grad():
        ours = eng(x).float()
        ref = plain.forward(params, x, dict(TINY),
                            plain.Ops(plain_qstate(qstate)))
    assert rel_err(ours, ref) < (0.05 if dtype == torch.float32 else 0.08)
    assert torch.equal(ours.argmax(1), ref.argmax(1))
    n_blocks = sum(TINY["depths"])
    assert swinv2.cpb_counts()["cpb_hits"] == n_blocks
    assert swinv2.cpb_counts()["cpb_builds"] == 0


def test_engine_builds_its_terms_once(calibrated):
    _, _, _, net, qstate = calibrated
    swinv2.reset_cpb_counts()
    eng = ServingEngine(net, qstate, device="cpu")
    counts = swinv2.cpb_counts()
    n_blocks = sum(TINY["depths"])
    # the shifted blocks' terms are (nW, H, N, N), the others (H, N, N)
    want = 0
    for i, depth in enumerate(TINY["depths"]):
        for j in range(depth):
            ws, shift = CFG.block_geometry(i, j)
            nw = (CFG.layer_resolution(i) // ws) ** 2 if shift else 1
            want += 4 * nw * TINY["num_heads"][i] * ws ** 4
    assert counts == {"cpb_builds": n_blocks, "cpb_hits": 0,
                      "term_bytes": want}
    # a request reads the engine's terms; a forward without an engine
    # builds its own
    with torch.no_grad():
        eng(images(2))
        net.apply(images(2), qstate=qstate, int8="fused")
    counts = swinv2.cpb_counts()
    assert counts["cpb_hits"] == n_blocks
    assert counts["cpb_builds"] == 2 * n_blocks


def _spans(fn, tmp_path):
    """The ``ptq.*`` span counts of ``fn`` run under a CPU profiler."""
    import json
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("ptq."):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def test_spans_of_v2_serving(calibrated, tmp_path):
    """A request reads the engine's terms (no ``ptq.forward.cpb``); each
    block enters B10 (its epilogue normalizing q and k), B9, B11, fc1,
    fc2 and the two post-norms under their wrappers' spans.  A fused forward
    without an engine runs the CPB network once a block under
    ``ptq.forward.cpb``."""
    _, _, _, net, qstate = calibrated
    eng = ServingEngine(net, qstate, device="cpu")
    n = sum(TINY["depths"])
    with torch.no_grad():
        got = _spans(lambda: eng(images(1)), tmp_path)
        bare = _spans(lambda: net.apply(images(1), qstate=qstate,
                                        int8="fused"), tmp_path)
    assert "ptq.forward.cpb" not in got and bare["ptq.forward.cpb"] == n
    for k, per in (("q8_win_qkv", 1), ("fused_window_attention_qkv", 1),
                   ("q8_win_proj", 1), ("q8_postnorm", 2)):
        assert got[f"ptq.kernel.{k}"] == per * n, k
    assert got["ptq.forward.block"] == n


def test_relaxed_serving_raises(calibrated):
    _, _, _, net, qstate = calibrated
    with pytest.raises(ValueError, match="relaxed"):
        ServingEngine(net, qstate, device="cpu", relaxed=True)(images(1))


# -- the V2 serving kernels' plain versions --------------------------------

def _acc(shape, seed, hi=20000):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-hi, hi, shape, generator=g, dtype=torch.int32)


@pytest.mark.parametrize("heads,hd", [(4, 32), (3, 16)])
def test_qkv_norm_plain_version_normalizes_per_head(heads, hd):
    """B10 with ``norm_heads``: q and k unit-norm per head before their
    levels, v as B6 requantizes it -- the plain version against
    F.normalize of the rescaled sums, each level within one of it (the
    sum of squares in the kernel's order)."""
    C, ws, res = heads * hd, 4, 8
    g = torch.Generator().manual_seed(hd)
    x4 = torch.randn((2, res, res, C), generator=g)
    w = torch.randint(-127, 128, (C, 3 * C), generator=g).to(torch.int8)
    w_scale = torch.rand(3 * C, generator=g) * 1e-3 + 1e-4
    b = torch.randn(3 * C, generator=g) * 0.1
    col = torch.cat([torch.full((2 * C,), 1 / 127.0),
                     torch.rand(C, generator=g) * 0.05 + 0.01])
    out = sv.q8_win_qkv(x4, w, w_scale, b, 0.02, None, ws, col, a_qmax=128,
                        norm_heads=heads)
    from ptq4vit_tpu_torch.models.swin import window_partition
    acc = sv.q8_linear_ref(window_partition(x4, ws), w, w_scale, b, 0.02,
                           None, a_qmax=128, postgelu=False, out_q="acc")
    M = acc[0].numel() // (3 * C)
    v = (acc[0].float().reshape(M, 3 * C) * 0.02 * w_scale + b) \
        .reshape(M, 3, heads, hd)
    v = torch.cat([torch.nn.functional.normalize(v[:, :2], dim=-1), v[:, 2:]],
                  1).reshape(M, -1)
    want = torch.clamp(torch.round(v / col), -128, 127)
    assert out.dtype == torch.int8 and out.shape == (2 * 4, ws * ws, 3 * C)
    d = (out.reshape(M, -1).float() - want).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("C,heads", [(48, 1), (96, 2)])
def test_qkv_norm_needs_heads_within_a_warp(C, heads):
    """The normalizing epilogue sums a head's squares over one warp's
    lanes: a head of 48 columns is refused, on the CPU as on the card."""
    w = torch.zeros((C, 3 * C), dtype=torch.int8)
    with pytest.raises(ValueError, match="divide 32"):
        sv.q8_win_qkv(torch.zeros((1, 4, 4, C)), w, torch.ones(3 * C), None,
                      0.02, None, 4, torch.ones(3 * C), a_qmax=128,
                      norm_heads=heads)


@pytest.mark.parametrize("planes", [1, 2])
def test_postnorm_plain_version(planes):
    """residual + LayerNorm(rescaled sums), in the window layout's row map
    for one plane (B11) and the twin's two planes for fc2 (B6)."""
    C, ws, res, B = 64, 4, 8, 2
    M = B * res * res
    acc = _acc((planes, B * (res // ws) ** 2, ws * ws, C), 2)
    w_scale = torch.rand(C) * 1e-3 + 1e-4
    bias = torch.randn(C) * 0.1
    lnw, lnb = 1 + 0.1 * torch.randn(C), 0.1 * torch.randn(C)
    resid = torch.randn(B, res, res, C)
    a_neg = 0.003 if planes == 2 else None
    out = sv.q8_postnorm(acc, w_scale, bias, 0.02, a_neg, (lnw, lnb, 1e-5),
                         resid, window=(ws, res))
    v = acc[0].float() * 0.02
    if planes == 2:
        v = v + acc[1].float() * 0.003
    v = v * w_scale + bias
    y = plain.layer_norm(v, lnw, lnb, 1e-5)
    from ptq4vit_tpu_torch.models.swin import window_reverse
    want = window_reverse(y, ws, res, res) + resid
    assert out.shape == resid.shape
    assert rel_err(out, want) < 1e-5
    assert M == out.numel() // C


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("res,ws,C,heads", [(96, 24, 128, 4),
                                            (24, 24, 512, 16),
                                            (12, 12, 1024, 32),
                                            (16, 8, 48, 3)])
def test_b10_normalize_epilogue_on_the_card(res, ws, C, heads):
    """B10 with no LayerNorm and q and k normalized per head in its
    epilogue, bitwise its plain version (SwinV2-B/384's stages, and 16
    columns a head at a ragged width)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(res + C)
    B = 2
    x4 = torch.randn((B, res, res, C), generator=g, device=dev) \
        .to(torch.bfloat16)
    w = torch.randn((3 * C, C), generator=g, device=dev) * C ** -0.5
    qp = _linear_qp(w, 0.05, dev)
    pw = sv.packed_or_compute(w, qp, {})
    b = torch.randn(3 * C, generator=g, device=dev) * 0.1
    col = torch.cat([torch.full((2 * C,), 1 / 127.0, device=dev),
                     torch.rand(C, generator=g, device=dev) * 0.05 + 0.01])
    out = sv.q8_win_qkv(x4, pw.w_intT, pw.w_scale, b, 0.05, None, ws, col,
                        a_qmax=128, w_kmaj=pw.w_kmaj, norm_heads=heads)
    want = sv.q8_win_qkv_ref(x4, pw.w_intT, pw.w_scale, b, 0.05, None, ws,
                             col, a_qmax=128, norm_heads=heads)
    assert torch.equal(out, want)


def _linear_qp(w, a, dev):
    from ptq4vit_tpu_torch.quant.qparams import LinearQP
    wi = (w.abs().amax() / 127.5).reshape(1, 1, 1, 1)
    return LinearQP(w_interval=wi, a_interval=torch.full((1, 1), a,
                                                         device=dev),
                    a_neg_interval=None, postgelu=False, w_bit=8, a_bit=8)


@pytest.mark.cuda
@pytest.mark.parametrize("N,heads,nw,shifted", [(576, 4, 16, True),
                                                 (576, 16, 1, False),
                                                 (144, 32, 1, False)])
def test_b9_per_head_tau_on_the_card(N, heads, nw, shifted):
    """B9 on int8 q̂, k̂, v with a per-head τ folded into the q scale and a
    held term, at SwinV2-B/384's windows (576 keys: the team mode; 144
    parked): its context levels against the plain version, each within
    one level (the softmax sum is reduced in another order)."""
    _card()
    out, want = _b9_case(N, heads, nw, shifted)
    d = (out.float() - want.float()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3


@pytest.mark.cuda
def test_b9_team_mode_counts_its_launches_on_the_card():
    """B9 int8 SoS at SwinV2-B/384's stage 2 (576 keys, 8 heads, 4
    shifted windows) runs in the team mode: ``attention_team`` counts the
    launch beside ``fused_window_attention_qkv``, and its context levels
    keep the one-level class against the plain version."""
    _card()
    assert sv.attn_plan(576, 32).team
    sv.reset_launch_counts()
    out, want = _b9_case(576, 8, 4, True)
    counts = sv.launch_counts()
    assert counts["attention_team"] == counts[
        "fused_window_attention_qkv"] == 1
    d = (out.float() - want.float()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3


def _b9_case(N, heads, nw, shifted):
    """B9 int8 SoS on random int8 q̂, k̂, v (2 images of ``nw`` windows of
    N tokens, ``heads`` heads of 32), a sigmoid bias (+ the shifted mask),
    τ per head; returns (the kernel's context levels, the plain
    version's)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(N + heads)
    hd, B = 32, 2 * nw
    qkv = torch.randint(-128, 128, (B, N, 3 * heads * hd), generator=g,
                        device=dev, dtype=torch.int8)
    ws = int(N ** 0.5)
    bias = 16 * torch.sigmoid(torch.randn((heads, N, N), generator=g,
                                          device=dev))
    mask = None
    if shifted:
        from ptq4vit_tpu_torch.models.swin import device_shifted_window_mask
        mask = device_shifted_window_mask(ws * round(nw ** 0.5), ws,
                                          ws // 2, dev, torch.float32)
    term = sv.window_term(bias, mask)
    tau = torch.exp(torch.rand(heads, generator=g, device=dev) * 4.6)
    qp1, qp2 = _attn_qps(heads, dev)
    args = (qkv, heads, nw, qp1, qp2, 1.0, None, None)
    kw = dict(in_q8=True, out_scale=torch.tensor(0.02, device=dev),
              term=term, tau=tau)
    out = sv.fused_window_attention_qkv(*args, **kw)
    ph, sos = sv.window_attn_scope(qp1, qp2, heads, 1.0)
    ph = torch.cat([ph[:1] * tau[None], ph[1:]])
    want = sv.fused_window_attention_ref(
        qkv, heads, nw, ph, qp2.split, 1.0, None, None,
        torch.tensor(0.02, device=dev), sos=sos, in_q8=True,
        qmaxes=sv.attn_qmaxes(qp1, qp2, 128), out_dtype=torch.float32,
        term=term)
    return out, want


def _attn_qps(heads, dev):
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP

    def iv(v):
        return torch.full((1, heads, 1, 1, 1, 1, 1), v, device=dev)
    qp1 = MatMulQP(A_interval=iv(1 / 127.0), B_interval=iv(1 / 127.0),
                   split=None, A_bit=8, B_bit=8)
    qp2 = MatMulQP(A_interval=torch.tensor(2.0 ** -5 / 127, device=dev),
                   B_interval=iv(0.05), split=torch.tensor(2.0 ** -5,
                                                           device=dev),
                   A_bit=8, B_bit=8)
    return qp1, qp2


@pytest.mark.cuda
@pytest.mark.parametrize("planes,window", [(1, (24, 96)), (1, (24, 24)),
                                           (2, None)])
def test_postnorm_on_the_card(planes, window):
    """The res-post-norm kernel bitwise its plain version: B11's sums in
    the window layout (a shifted stage-1 map and a one-window stage-3
    map) and fc2's twin planes."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(planes)
    C = 128 if window and window[1] == 96 else 512
    B = 2
    if window:
        ws, res = window
        lead = (B * (res // ws) ** 2, ws * ws)
        rshape = (B, res, res, C)
    else:
        lead = (B, 576)
        rshape = lead + (C,)
    acc = torch.randint(-20000, 20000, (planes,) + lead + (C,), generator=g,
                        device=dev, dtype=torch.int32)
    w_scale = torch.rand(C, generator=g, device=dev) * 1e-3 + 1e-4
    bias = torch.randn(C, generator=g, device=dev) * 0.1
    ln = (1 + 0.1 * torch.randn(C, generator=g, device=dev),
          0.1 * torch.randn(C, generator=g, device=dev), 1e-5)
    resid = torch.randn(rshape, generator=g, device=dev).to(torch.bfloat16)
    a_neg = torch.tensor(0.003, device=dev) if planes == 2 else None
    a = torch.tensor(0.02, device=dev)
    out = sv.q8_postnorm(acc, w_scale, bias, a, a_neg, ln, resid,
                         window=window)
    want = sv.q8_postnorm_ref(acc, w_scale, bias, a, a_neg, ln, resid,
                              window=window)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(calibrated):
    """The tiny V2's fused engine on the card against the same engine on
    the CPU (the plain versions): float32 logits within 1e-3 of the
    largest."""
    dev = _card()
    _, _, _, net, qstate = calibrated
    x = images(4, seed=13)
    cpu = ServingEngine(net, qstate, device="cpu",
                        compute_dtype=torch.float32)(x)
    card_net = dataclasses.replace(
        net, params=_to(net.params, dev))
    card = ServingEngine(card_net, qstate, device=dev,
                         compute_dtype=torch.float32)(x)
    assert rel_err(card.cpu(), cpu) < 1e-3


def _to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]
