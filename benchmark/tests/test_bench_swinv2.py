"""The Swin V2 serving cell's pieces on the CPU at a tiny size: the
benchmark's reference against the program's fake-quant forward and
against the test suite's independent plain V2, whole runs of a tiny V2
serving cell, the window attention counts, and the faults that
``correct`` has to catch: logits swapped between images, τ left out,
the post-norm applied pre-norm."""
import math

import pytest
import torch

from benchmark import counts, counts_window, harness, model
from benchmark.reference import serve as ref_serve
from benchmark.reference import swinv2 as ref
from benchmark.tests.test_bench_harness import TINY_SERVE
from benchmark.traffic import serve_swinv2 as gen

TINY_V2 = {"kind": "swinv2", "img_size": 64, "patch_size": 4,
           "embed_dim": 32, "depths": [2, 2, 2], "num_heads": [2, 4, 8],
           "window_size": 8, "pretrained_window_sizes": [4, 4, 2],
           "mlp_ratio": 4.0, "num_classes": 10, "ln_eps": 1e-5,
           "in_chans": 3}
CELL = "swinv2_b384.serve32v2"
# The tiny net's own limits: its levels are coarse (head dim 16, 10
# classes), so over seeds 2^33 + 7, 41, 21 and 99 the program reads
# logit_rms 0.055-0.083 and logit_err 0.067-0.147, and the float8 control
# 0.168-0.283 and 0.194-0.626 (CPU); the cell's limits are set at full
# width, where the program reads 2.3 times under them.
TINY_LIMITS = {"logit_rms": 0.12, "logit_err": 0.18}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_v2_cell():
    src = harness.load_cell(CELL)
    return harness.Cell(
        name="tiny.v2", config={"name": "tiny", "model": TINY_V2},
        mix=dict(TINY_SERVE, generator="serve_swinv2"),
        limits=dict(TINY_LIMITS), end_to_end=src.end_to_end,
        per_layer=src.per_layer, units=src.units)


def test_reference_is_the_ports_fake_quant():
    """The reference's served model is the program's fake-quant forward
    on the same weights and qstate (float32)."""
    params = gen.make_params(TINY_V2, 5, "cpu")
    x = model.make_images(4, TINY_V2, 5, "cpu")
    plain = gen.serving_qstate(params, TINY_V2, x)
    from ptq4vit_tpu_torch.models.registry import net_from_config
    net = net_from_config(gen.port_config(TINY_V2, "tiny"), params)
    ours = ref.logits(params, TINY_V2, plain, x)
    with torch.no_grad():
        port = net.apply(x, qstate=model.port_qstate(plain, TINY_V2))
        floats = net.apply(x)
    assert ref_serve.judge(port, ours)["logit_rms"] < 1e-5
    # and the float forward of the test suite's independent plain V2
    from tests import plain_swinv2
    want = plain_swinv2.forward(params, x, TINY_V2)
    got = ref.forward(params, x, TINY_V2, ref.Hooks())
    assert ref_serve.judge(got, want)["logit_rms"] < 1e-6
    assert ref_serve.judge(floats, want)["logit_rms"] < 1e-5


def test_config_is_the_registry_row():
    """The configuration file's model group is the registry row, through
    the generator's bridge (``model.port_config`` builds V1's
    SwinConfig)."""
    from ptq4vit_tpu_torch.models.registry import model_config
    conf = harness.load_json(harness.HERE, "configs", "swinv2_b384.json")
    assert gen.port_config(conf["model"], conf["registry"]) == \
        model_config(conf["registry"])


def test_params_follow_timms_init():
    params = gen.make_params(TINY_V2, 7, "cpu")
    a = params["layers"][0]["blocks"][1]["attn"]
    assert torch.equal(a["logit_scale"],
                       torch.full((2, 1, 1), math.log(10.0)))
    b = a["qkv"]["bias"]
    assert torch.equal(b[32:64], torch.zeros(32)) and b[:32].abs().max() > 0
    assert a["cpb_mlp"]["0"]["weight"].shape == (512, 2)
    assert a["cpb_mlp"]["2"]["weight"].shape == (2, 512)
    assert "bias" not in a["cpb_mlp"]["2"]
    assert params["layers"][0]["downsample"]["norm"]["weight"].shape == (64,)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_v2_cell_runs(trace):
    cell = tiny_v2_cell()
    result, compared, run = harness.run_cell(cell, 2 ** 33 + 7, 0.5,
                                             bool(trace), "cpu")
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {"setup_s", "serve_img_s",
                                          "serve_p95_ms"}


def test_control_is_not_correct():
    """The reference computed in float8 between the ops, the precision
    below the configuration's bfloat16, reads beyond a limit."""
    cell = tiny_v2_cell()
    result, compared, run = harness.run_cell(cell, 21, 0.2, False, "cpu",
                                             control=True)
    assert result["correct"], compared
    control = run.records["control"]
    assert any(control[k] > lim for k, lim in cell.limits.items()), control


def _prenorm_block(x, blk, qps, pks, heads, ws, shift, res, bias, tau, mask,
                   ln_eps, term=None):
    """The V2 block with its LayerNorms moved before the branches (V1's
    pre-norm order): a planted fault."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    qs = sv._block_scope(qps, heads)
    qp_qkv, qp1, qp2, qp_proj, qp_fc1, qp_fc2 = qs
    B, T, C = x.shape
    w_qkv, w_proj, w_fc1, w_fc2 = sv._block_weights(blk, qs, pks)
    hd = sv._head_dim(w_qkv, heads)
    attn, mlp = blk["attn"], blk["mlp"]
    x4 = x.reshape(B, res, res, C)
    if shift:
        x4 = torch.roll(x4, (-shift, -shift), dims=(1, 2))
    q = sv.q8_win_qkv(x4, w_qkv.w_intT, w_qkv.w_scale, attn["qkv"]["bias"],
                      qp_qkv.a_interval[0, 0],
                      (blk["norm1"]["weight"], blk["norm1"]["bias"], ln_eps),
                      ws, sv._col_scales(sv.head_scalar(qp1.A_interval,
                                                        heads),
                                         qp1, qp2, heads, hd),
                      a_qmax=qp_qkv.a_qmax, norm_heads=heads)
    y_q = sv.fused_window_attention_qkv(
        q, heads, (res // ws) ** 2 if shift else 1, qp1, qp2, 1.0, bias,
        mask, in_q8=True, out_scale=qp_proj.a_interval[0, 0], term=term,
        tau=tau)
    y4 = sv.q8_win_proj(y_q, w_proj.w_intT, w_proj.w_scale,
                        attn["proj"]["bias"], qp_proj.a_interval[0, 0], ws,
                        res, x4, a_qmax=qp_proj.a_qmax)
    if shift:
        y4 = torch.roll(y4, (shift, shift), dims=(1, 2))
    return sv._fused_mlp(y4.reshape(B, T, C), blk, qp_fc1, qp_fc2, w_fc1,
                         w_fc2, ln_eps)


@pytest.mark.parametrize("fault", ["swapped", "no_tau", "prenorm"])
def test_faults_are_not_correct(monkeypatch, fault):
    """One image's logits another's; the logit scale τ left out of the
    attention (B9's q scale not multiplied by it); the block's
    LayerNorms applied before its branches instead of after them."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.parallel import serve
    if fault == "swapped":
        call = serve.ServingEngine.__call__

        def broken(self, x):
            out = call(self, x).clone()
            out[0] = out[1]
            return out
        monkeypatch.setattr(serve.ServingEngine, "__call__", broken)
    elif fault == "no_tau":
        fn = sv.fused_window_attention_qkv

        def untau(*a, tau=None, **k):
            return fn(*a, **k)
        monkeypatch.setattr(sv, "fused_window_attention_qkv", untau)
    else:
        monkeypatch.setattr(sv, "fused_swinv2_block", _prenorm_block)
    result, compared, _ = harness.run_cell(tiny_v2_cell(), 41, 0.2, False,
                                           "cpu")
    assert not result["correct"], compared


def test_window_counts():
    """The window attention's products and bytes at SwinV2-B/384 with 32
    images: 10.3 G multiply-adds an image, q, k, v in and the context out
    once a head and window, and each block's term once: the 18 one-window
    stage-3 blocks' (16 heads, 576 x 576) and the shifted stage-1 block's
    (16 windows, 4 heads)."""
    cfg = harness.load_json(harness.HERE, "configs", "swinv2_b384.json")[
        "model"]
    w = counts_window.window_work(cfg, 32)
    ops = [op for op in counts.op_shapes(cfg) if op["kind"] == "matmul"]
    macs = sum(2 * counts.macs(op) for op in ops)
    assert w["int8"] == 2 * macs * 32
    assert abs(macs / 1e9 - 10.3) < 0.1
    assert counts_window.shifted(cfg, "layers.0.blocks.1.attn.matmul1")
    assert not counts_window.shifted(cfg, "layers.2.blocks.1.attn.matmul1")
    assert not counts_window.shifted(cfg, "layers.3.blocks.1.attn.matmul1")
    terms = sum((op["S"] if counts_window.shifted(cfg, op["name"]) else 1)
                * op["G"] * op["R"] * op["Co"] * 4 for op in ops)
    io = sum(op["S"] * op["G"] * 32 * op["R"] * (3 * op["Ci"] + 2 * op["Ci"])
             for op in ops)
    assert w["bytes"] == io + terms
    assert 18 * 16 * 576 ** 2 * 4 < terms < 0.6e9


def test_window_readers_pick_kernels_by_name():
    """The window readers sum the device time of their kernels by name,
    a template's instances included, and read nothing where none ran."""
    import types

    from benchmark import trace
    from benchmark.metrics import _window
    ev = [("void (anonymous namespace)::attention_kernel<true, 32, true, "
           "false, false>(AttnArgs)", 0, 3000),
          ("void (anonymous namespace)::attention_kernel<false, 64, true, "
           "false, false>(AttnArgs)", 3000, 1000),
          ("void (anonymous namespace)::postnorm_kernel<2>(Q8Args, int "
           "const*)", 4500, 250),
          ("void (anonymous namespace)::postnorm_kernel<1>(Q8Args, int "
           "const*)", 4750, 250)]
    tr = trace.Trace([{"ph": "X", "cat": "kernel", "name": n, "ts": ts,
                       "dur": d} for n, ts, d in ev])
    assert _window.kernel_s(tr) == pytest.approx(3e-3)
    cfg = harness.load_json(harness.HERE, "configs", "swinv2_b384.json")[
        "model"]
    run = types.SimpleNamespace(trace=tr, records={"traced_n": 2}, cfg=cfg,
                                mix={"batch": 32})
    work = counts_window.row_epilogue_work(cfg, 32)
    assert _window.row_roofline(run, "postnorm_kernel",
                                counts_window.row_epilogue_work,
                                "postnorm") == pytest.approx(
        100 * work["postnorm"] * 2 / 5e-4)
    run.trace = trace.Trace([])
    assert _window.row_roofline(run, "postnorm_kernel",
                                counts_window.row_epilogue_work,
                                "postnorm") is None
