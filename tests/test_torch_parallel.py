"""The port's device mesh on gloo ranks of the CPU
(ptq4vit_tpu_torch/parallel): ranks and their backend, ``shard_params``,
data-parallel evaluation over 2 and 4 ranks and tensor-parallel evaluation
over a (2, 2) mesh in raw FP32, fake-quant, ``int8=True`` and
``int8="fused"`` (the whole-block paths of ViT and Swin, and the per-op
path, W8A8 and W6A6), and the scope errors.  Each result is held against
the port on one device and against the JAX package's ``make_mesh`` in this
process (tests/test_parallel.py's cases); the ranks run
tests/torch_mesh_workers.py, one spawn a fixture."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.parallel import Evaluator as JEvaluator
from ptq4vit_tpu.parallel import make_mesh as jmake_mesh
from ptq4vit_tpu.parallel.mesh import shard_batch as jshard_batch
from ptq4vit_tpu.parallel.mesh import shard_params as jshard_params
from ptq4vit_tpu_torch.parallel import Evaluator, launch
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests import torch_mesh_workers as W
from tests.torch_port_helpers import (TINY, TINY_SWIN, WIDE,
                                      assert_logits_close, images, jax_net,
                                      jax_swin_net, minmax_qstate, port_net,
                                      shrink)

# tests/test_capture.py's tiny ViT with 4 heads (3 do not split over 2)
TINY4 = dict(TINY, num_heads=4)
# tests/test_int8_serve.py:133's ViT in the JAX fused block's scope
# (embed 128, 2 heads of 64: one a rank over model=2)
WIDE2 = dict(WIDE, depth=2)


def labels(n, seed):
    return np.random.default_rng(seed).integers(0, 10, n).astype(np.int64)


@pytest.fixture(scope="module")
def nets():
    """The tiny ViT (3 heads) and TINY4 with a JAX-calibrated qstate."""
    jnet3, jnet4 = jax_net(TINY), jax_net(TINY4)
    jq4 = HessianQuantCalibrator(jnet4, shrink(jptq4vit()), images(8, 32),
                                 batch_size=4) \
        .batching_quant_calib(verbose=False)
    return jnet3, jnet4, jq4


def eval_tasks(spec, **extra):
    x16, y16 = images(16, 32, seed=5), labels(16, 6)
    tasks = {"eval16": dict(task="eval", net=spec, x=x16, y=y16),
             "eval13": dict(task="eval", net=spec, x=x16[:13], y=y16[:13])}
    tasks.update(extra)
    return tasks


@pytest.fixture(scope="module")
def dp2(nets, tmp_path_factory):
    jnet3, jnet4, jq4 = nets
    loader = [(images(4, 32, seed=10 + i), labels(4, 20 + i))
              for i in range(5)]
    q = W.qstate_to_np(qstate_from_numpy(jq4))
    tasks = eval_tasks(
        W.net_spec(jnet3),
        loader=dict(task="eval", net=W.net_spec(jnet3), x=loader[0][0],
                    y=loader[0][1], loader=loader),
        quant=dict(task="eval", net=W.net_spec(jnet4), qstate=q,
                   x=images(8, 32, seed=7), y=labels(8, 8)))
    return W.run_job(tmp_path_factory.mktemp("dp2"), 2, tasks), loader


@pytest.fixture(scope="module")
def dp4(nets, tmp_path_factory):
    return W.run_job(tmp_path_factory.mktemp("dp4"), 4,
                     eval_tasks(W.net_spec(nets[0])))


INT8 = {"raw": False, "fake": False, "int8": True, "fused": "fused"}
# the tiny Swin's qstates: min-max (its blocks fused whole), min-max with
# a plain fc2 (``no_postgelu``: the per-op fused path)
SWIN_QSTATES = {"raw": None, "int8": {}, "fused": {},
                "fused_per_op": {"postgelu": False}}


# the fused cases also run in the relaxed mode over model=2
RELAXED_CASES = ("swin_ptq4vit", "wide_ptq4vit")


@pytest.fixture(scope="module")
def fused_nets():
    """{case: (JAX net, qstate, images)} of the fused block paths under
    tensor parallelism: the tiny Swin and WIDE2 PTQ4ViT-calibrated (W8A8),
    and WIDE2 at W6A6 (min-max)."""
    cases = {}
    for key, make, shape in (("swin_ptq4vit", jax_swin_net, TINY_SWIN),
                             ("wide_ptq4vit", jax_net, WIDE2)):
        jnet = make(shape)
        q = HessianQuantCalibrator(jnet, shrink(jptq4vit()), images(8, 32),
                                   batch_size=4) \
            .batching_quant_calib(verbose=False)
        cases[key] = (jnet, q, images(4, 32, seed=14))
    jnet = jax_net(WIDE2)
    x = images(4, 32, seed=15)
    cases["wide_w6a6"] = (jnet, minmax_qstate(jnet, x, bits=6), x)
    return cases


@pytest.fixture(scope="module")
def tp(nets, fused_nets, tmp_path_factory):
    jnet3, jnet4, jq4 = nets
    spec, q = W.net_spec(jnet4), W.qstate_to_np(qstate_from_numpy(jq4))
    x, y = images(8, 32, seed=9), labels(8, 11)
    tasks = {mode: dict(task="eval", net=spec, x=x, y=y, tp=True,
                        qstate=None if mode == "raw" else q,
                        int8=INT8[mode])
             for mode in INT8}
    jswin = jax_swin_net(TINY_SWIN)
    swin = W.net_spec(jswin)
    xs = images(4, 32, seed=12)
    for mode, kw in SWIN_QSTATES.items():
        tasks[f"swin_{mode}"] = dict(
            task="eval", net=swin, x=xs, y=labels(4, 13), tp=True,
            int8=INT8[mode.split("_")[0]], qstate=None if kw is None else
            W.qstate_to_np(qstate_from_numpy(minmax_qstate(jswin, xs,
                                                           **kw))))
    for key, (jnet, jq, xf) in fused_nets.items():
        tasks[key] = dict(task="eval", net=W.net_spec(jnet), x=xf,
                          y=labels(len(xf), 16), tp=True, int8="fused",
                          qstate=W.qstate_to_np(qstate_from_numpy(jq)))
        if key in RELAXED_CASES:
            tasks[f"{key}_relaxed"] = dict(tasks[key], int8="fused_relaxed")
    tasks["shard"] = dict(task="shard_params", net=spec)
    tasks["errors"] = dict(task="errors", net=W.net_spec(jnet3),
                           qstate=W.qstate_to_np(qstate_from_numpy(jq4)),
                           x=images(4, 32))
    return W.run_job(tmp_path_factory.mktemp("tp"), 4, tasks,
                     model_parallel=2), x, y


def same_on_every_rank(results, key, field):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key][field], results[0][key][field])


def test_backend_follows_the_device_map(monkeypatch):
    assert launch.choose_backend(["cpu", "cpu"]) == "gloo"
    assert launch.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert launch.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert launch.choose_backend(["cuda:0", "cpu"]) == "gloo"
    # no card here: the CPU only when asked for, else an error
    assert launch.default_devices(3, "cpu") == ["cpu"] * 3
    for call in (lambda: launch.default_devices(3),
                 lambda: launch.default_devices(3, "cuda"),
                 launch.rank_device,
                 lambda: launch.spawn(W.fail_on_rank1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch.default_devices(3) == ["cuda:0", "cuda:1", "cuda:0"]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="card of its own"):
        launch.spawn(W.fail_on_rank1, 2, devices=["cpu", "cpu"],
                     backend="nccl")


def test_run_from_env_under_a_torchrun_environment(monkeypatch, capsys):
    """One rank as torchrun starts it (RANK, WORLD_SIZE, MASTER_* and the
    local ranks in the environment): the device map's backend, the rank's
    device, a collective, the group ended."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(launch, "_DEVICE", None)
    seen = []

    def fn(rank, x):
        t = torch.tensor([x])
        dist.all_reduce(t)
        seen.append((rank, dist.get_world_size(), dist.get_backend(),
                     launch.rank_device(), float(t)))

    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_from_env(fn, 2.5)          # the card, and there is none
    assert seen == [] and not dist.is_initialized()
    launch.run_from_env(fn, 2.5, device="cpu")
    assert seen == [(0, 1, "gloo", torch.device("cpu"), 2.5)]
    assert not dist.is_initialized()
    assert "backend gloo, ranks -> devices 0: cpu" in capsys.readouterr().out


def test_a_rank_error_ends_the_launch(tmp_path):
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        launch.spawn(W.fail_on_rank1, 2, devices=["cpu", "cpu"],
                     init_method=f"file://{tmp_path}/rendezvous")


def test_a_hung_collective_ends_at_the_timeout(tmp_path):
    import datetime
    t0 = time.time()
    with pytest.raises(Exception):
        launch.spawn(W.hang_on_rank1, 2, devices=["cpu", "cpu"],
                     init_method=f"file://{tmp_path}/rendezvous",
                     timeout=datetime.timedelta(seconds=3))
    assert time.time() - t0 < 60


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["eval16", "eval13"])
def test_dp_eval_matches_single_device(nets, dp2, dp4, world, case):
    """tests/test_parallel.py test_dp_eval_matches_single_device and
    test_dp_eval_with_padding (13 samples padded with label -1)."""
    results = dp2[0] if world == 2 else dp4
    jnet = nets[0]
    x16, y16 = images(16, 32, seed=5), labels(16, 6)
    n = 16 if case == "eval16" else 13
    x, y = x16[:n], y16[:n]
    single = Evaluator(port_net(jnet), device="cpu")
    want = single.n_correct(x, y)
    assert want == JEvaluator(jnet).n_correct(jnp.asarray(x),
                                              jnp.asarray(y))
    assert want == JEvaluator(jnet, mesh=jmake_mesh(world)).n_correct(x, y)
    for r in results:
        assert r[case]["n_correct"] == want
    np.testing.assert_allclose(results[0][case]["logits"],
                               single.logits(x).numpy(), rtol=1e-5,
                               atol=1e-6)
    same_on_every_rank(results, case, "logits")


def test_pipelined_evaluate_matches_sync(nets, dp2):
    results, loader = dp2
    jnet = nets[0]
    want = Evaluator(port_net(jnet), device="cpu").evaluate(loader)
    assert want == JEvaluator(jnet).evaluate(loader, pipeline=0)
    assert want == JEvaluator(jnet, mesh=jmake_mesh(2)).evaluate(
        loader, pipeline=8)
    for r in results:
        assert r["loader"]["accuracy"] == want


def test_mesh_quantized_eval(nets, dp2):
    """A calibrated qstate drives the mesh's fake-quant eval."""
    _, jnet4, jq4 = nets
    x, y = images(8, 32, seed=7), labels(8, 8)
    want = Evaluator(port_net(jnet4), qstate_from_numpy(jq4),
                     device="cpu").n_correct(x, y)
    assert want == JEvaluator(jnet4, qstate=jq4, mesh=jmake_mesh(2)) \
        .n_correct(x, y)
    for r in dp2[0]:
        assert r["quant"]["n_correct"] == want


@pytest.mark.parametrize("mode", list(INT8))
def test_tp_eval_matches_single_device(nets, tp, mode):
    """Tensor parallelism over a (2, 2) mesh (tests/test_parallel.py
    test_tp_eval_matches_single_device): the counts equal the port's and
    JAX's, on one device and on JAX's make_mesh(4, 2); the row-parallel
    int8 dots (int8=True) and the fused kernels' int32 sums (int8="fused",
    before their epilogue) are reduced exactly, so both int8 modes' logits
    are bitwise the single device's."""
    _, jnet4, jq4 = nets
    results, x, y = tp
    qstate = None if mode == "raw" else jq4
    int8 = INT8[mode]
    single = Evaluator(port_net(jnet4), None if qstate is None
                       else qstate_from_numpy(qstate), int8=int8,
                       device="cpu")
    want = single.n_correct(x, y)
    assert want == JEvaluator(jnet4, qstate=qstate, int8=int8).n_correct(
        jnp.asarray(x), jnp.asarray(y))
    assert want == JEvaluator(jnet4, qstate=qstate, int8=int8,
                              mesh=jmake_mesh(4, model_parallel=2),
                              tensor_parallel=True).n_correct(x, y)
    for r in results:
        assert r[mode]["n_correct"] == want
    ref = single.logits(x).numpy()
    got = results[0][mode]["logits"]
    if int8:
        np.testing.assert_array_equal(got, ref)
    elif mode == "raw":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert_logits_close(got, ref)
    same_on_every_rank(results, mode, "logits")
    if mode == "fused":      # TINY4's blocks fused whole on every rank
        for r in results:
            assert r[mode]["hits"]["fused_vit_block"] == TINY4["depth"]


@pytest.mark.parametrize("mode", list(SWIN_QSTATES))
def test_tp_swin_eval_matches_single_device(tp, mode):
    """The tiny Swin (heads 2 and 4) over model=2: each rank's heads, with
    its columns of the rel-pos bias table; raw logits to rounding, both
    int8 modes bitwise.  Fused: every block through the whole-block path
    (B11 and fc2 row-parallel) with the min-max qstate, and through the
    per-op path (B6 row-parallel proj and fc2) with its plain fc2."""
    results = tp[0]
    jnet = jax_swin_net(TINY_SWIN)
    xs = images(4, 32, seed=12)
    kw = SWIN_QSTATES[mode]
    q = None if kw is None else qstate_from_numpy(minmax_qstate(jnet, xs,
                                                               **kw))
    int8 = INT8[mode.split("_")[0]]
    single = Evaluator(port_net(jnet), q, int8=int8, device="cpu")
    ref = single.logits(xs).numpy()
    key = f"swin_{mode}"
    got = results[0][key]["logits"]
    if int8:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    same_on_every_rank(results, key, "logits")
    blocks = sum(TINY_SWIN["depths"])
    for r in results:
        assert r[key]["n_correct"] == single.n_correct(xs, labels(4, 13))
        if int8 == "fused":
            per_op = mode == "fused_per_op"
            assert r[key]["hits"] == {"fused_vit_block": 0,
                                      "fused_swin_block":
                                          0 if per_op else blocks,
                                      "row_parallel": 2 * blocks}


def jax_fused_on_mesh(jnet, jq, x):
    """JAX's fused int8 logits with the params on shard_params(...) of
    make_mesh(4, model_parallel=2) and the batch over "data" (GSPMD
    partitions the forward)."""
    mesh = jmake_mesh(4, model_parallel=2)
    # the qstate an argument, as JEvaluator passes it: a closed-over one
    # is a constant XLA may fold (a division by an interval then becomes a
    # product with its reciprocal, and levels flip)
    fwd = jax.jit(lambda p, q, xb: jnet.forward(p, xb, jnet.cfg, qstate=q,
                                                int8="fused"))
    return np.asarray(fwd(jshard_params(jnet.params, mesh), jq,
                          jshard_batch(jnp.asarray(x), mesh)))


@pytest.mark.parametrize("case", ["swin_ptq4vit", "wide_ptq4vit",
                                  "wide_w6a6"])
def test_tp_fused_blocks_match_single_device_and_jax(fused_nets, tp, case):
    """int8="fused" over model=2 on the whole-block paths: the tiny Swin
    and WIDE2 (one head of 64 a rank) calibrated by PTQ4ViT at W8A8, and
    WIDE2 at W6A6 (qmax 32 on the same int8 operands).  Every rank fuses
    every block and runs its proj and fc2 row-parallel; the logits are the
    port's single device's bitwise and hold to JAX's fused logits on its
    tensor-parallel mesh with ``assert_logits_close`` (WIDE2's are equal)
    -- except the calibrated tiny Swin's.  Its heads of 6 are outside
    JAX's TPU tiling, so JAX's fused forward is its exact int8 one, and
    the two packages' exact int8 forwards part there on one device as
    well: a level flipped by a float op's rounding compounds through the
    calibrated quantizers (8.0e-3 of max |logit| on these images, the
    port's fused and exact forwards equal), so it holds to 1e-2 of max
    |logit| with the argmax equal."""
    jnet, jq, x = fused_nets[case]
    results = tp[0]
    single = Evaluator(port_net(jnet), qstate_from_numpy(jq), int8="fused",
                       device="cpu")
    ref = single.logits(x).numpy()
    same_on_every_rank(results, case, "logits")
    np.testing.assert_array_equal(results[0][case]["logits"], ref)
    swin = case.startswith("swin")
    blocks = sum(jnet.cfg.depths) if swin else jnet.cfg.depth
    for r in results:
        assert r[case]["hits"] == {
            "fused_vit_block": 0 if swin else blocks,
            "fused_swin_block": blocks if swin else 0,
            "row_parallel": 2 * blocks}
    jref = jax_fused_on_mesh(jnet, jq, x)
    if swin:
        assert (ref.argmax(-1) == jref.argmax(-1)).all()
        assert np.abs(ref - jref).max() <= 1e-2 * np.abs(jref).max()
    else:
        assert_logits_close(ref, jref)


@pytest.mark.parametrize("case", RELAXED_CASES)
def test_tp_fused_relaxed_matches_single_device(fused_nets, tp, case):
    """int8="fused_relaxed" over model=2 runs wherever "fused" runs: every
    rank fuses every block with the relaxed kernels' plain versions on its
    column-parallel qkv / attention / fc1 (their local heads and columns),
    while proj, fc2 and B11 (float outputs without GELU, the same in both
    modes) stay row-parallel; the logits are the single device's relaxed
    ones bitwise, and not its exact ones."""
    jnet, jq, x = fused_nets[case]
    key = f"{case}_relaxed"
    results = tp[0]
    single = Evaluator(port_net(jnet), qstate_from_numpy(jq),
                       int8="fused_relaxed", device="cpu")
    ref = single.logits(x).numpy()
    same_on_every_rank(results, key, "logits")
    np.testing.assert_array_equal(results[0][key]["logits"], ref)
    assert not np.array_equal(ref, results[0][case]["logits"])
    swin = case.startswith("swin")
    blocks = sum(jnet.cfg.depths) if swin else jnet.cfg.depth
    for r in results:
        assert r[key]["hits"] == r[case]["hits"] == {
            "fused_vit_block": 0 if swin else blocks,
            "fused_swin_block": blocks if swin else 0,
            "row_parallel": 2 * blocks}


def test_shard_params_concatenate_to_the_full_weights(nets, tp):
    """Each model rank's qkv rows are its heads of each of q, k and v; fc1
    its rows, proj and fc2 its columns; the head is whole everywhere."""
    _, jnet4, _ = nets
    results = tp[0]
    blk = W.np_tree(jnet4.params)["blocks"][0]
    by_m = {r["shard"]["coord"][1]: r["shard"] for r in results
            if r["shard"]["coord"][0] == 0}
    m0, m1 = by_m[0], by_m[1]
    qkv = np.concatenate([np.concatenate([p, q]) for p, q in zip(
        np.split(m0["qkv"], 3), np.split(m1["qkv"], 3))])
    np.testing.assert_array_equal(qkv, blk["attn"]["qkv"]["weight"])
    qkv_b = np.concatenate([np.concatenate([p, q]) for p, q in zip(
        np.split(m0["qkv_bias"], 3), np.split(m1["qkv_bias"], 3))])
    np.testing.assert_array_equal(qkv_b, blk["attn"]["qkv"]["bias"])
    np.testing.assert_array_equal(np.concatenate([m0["fc1"], m1["fc1"]]),
                                  blk["mlp"]["fc1"]["weight"])
    for k, full in (("proj", blk["attn"]["proj"]["weight"]),
                    ("fc2", blk["mlp"]["fc2"]["weight"])):
        np.testing.assert_array_equal(np.concatenate([m0[k], m1[k]], 1),
                                      full)
    np.testing.assert_array_equal(m0["proj_bias"],
                                  blk["attn"]["proj"]["bias"])
    for r in results:
        np.testing.assert_array_equal(r["shard"]["head"],
                                      r["shard"]["full_head"])


@pytest.mark.parametrize("case,kind,match", [
    ("tp_heads", "ValueError", "head count"),
    ("serve_batch", "ValueError", "pad it upstream"),
    ("capture", "ValueError", "not shardable"),
])
def test_scope_errors(tp, case, kind, match):
    """3 heads over model=2, a request of 3 over data=2 and 3 calibration
    images over data=2."""
    for r in tp[0]:
        got = r["errors"][case]
        assert got is not None and got[0] == kind and match in got[1], got
