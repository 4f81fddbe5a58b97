"""The port's device mesh on gloo ranks of the CPU
(ptq4vit_tpu_torch/parallel): ranks and their backend, ``shard_params``,
data-parallel evaluation over 2 and 4 ranks and tensor-parallel evaluation
over a (2, 2) mesh in raw FP32, fake-quant and ``int8=True``, and the scope
errors.  Each result is held against the port on one device and against
the JAX package's ``make_mesh`` in this process (tests/test_parallel.py's
cases); the ranks run tests/torch_mesh_workers.py, one spawn a fixture."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.parallel import Evaluator as JEvaluator
from ptq4vit_tpu.parallel import make_mesh as jmake_mesh
from ptq4vit_tpu_torch.parallel import Evaluator, launch
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests import torch_mesh_workers as W
from tests.torch_port_helpers import (TINY, TINY_SWIN, assert_logits_close,
                                      images, jax_net, jax_swin_net,
                                      minmax_qstate, port_net, shrink)

# tests/test_capture.py's tiny ViT with 4 heads (3 do not split over 2)
TINY4 = dict(TINY, num_heads=4)


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


@pytest.fixture(scope="module")
def tp(nets, tmp_path_factory):
    jnet3, jnet4, jq4 = nets
    spec, q = W.net_spec(jnet4), W.qstate_to_np(qstate_from_numpy(jq4))
    x, y = images(8, 32, seed=9), labels(8, 11)
    tasks = {mode: dict(task="eval", net=spec, x=x, y=y, tp=True,
                        qstate=None if mode == "raw" else q,
                        int8=mode == "int8")
             for mode in ("raw", "fake", "int8")}
    swin = W.net_spec(jax_swin_net(TINY_SWIN))
    xs = images(4, 32, seed=12)
    for mode in ("raw", "int8"):
        tasks[f"swin_{mode}"] = dict(
            task="eval", net=swin, x=xs, y=labels(4, 13), tp=True,
            int8=mode == "int8", qstate=None if mode == "raw" else
            W.qstate_to_np(qstate_from_numpy(minmax_qstate(
                jax_swin_net(TINY_SWIN), xs))))
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
    assert launch.default_devices(3) == ["cpu"] * 3     # no card here
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

    launch.run_from_env(fn, 2.5)
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


@pytest.mark.parametrize("mode", ["raw", "fake", "int8"])
def test_tp_eval_matches_single_device(nets, tp, mode):
    """Tensor parallelism over a (2, 2) mesh (tests/test_parallel.py
    test_tp_eval_matches_single_device): the counts equal the port's and
    JAX's, on one device and on JAX's make_mesh(4, 2); the row-parallel
    int8 dots are reduced exactly, so int8=True logits are bitwise."""
    _, jnet4, jq4 = nets
    results, x, y = tp
    qstate = None if mode == "raw" else jq4
    int8 = mode == "int8"
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
    if mode == "int8":
        np.testing.assert_array_equal(got, ref)
    elif mode == "raw":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert_logits_close(got, ref)
    same_on_every_rank(results, mode, "logits")


@pytest.mark.parametrize("mode", ["raw", "int8"])
def test_tp_swin_eval_matches_single_device(tp, mode):
    """The tiny Swin (heads 2 and 4) over model=2: each rank's heads, with
    its columns of the rel-pos bias table; raw logits to rounding,
    int8=True bitwise."""
    results = tp[0]
    jnet = jax_swin_net(TINY_SWIN)
    xs = images(4, 32, seed=12)
    q = None if mode == "raw" else qstate_from_numpy(minmax_qstate(jnet, xs))
    single = Evaluator(port_net(jnet), q, int8=mode == "int8", device="cpu")
    ref = single.logits(xs).numpy()
    got = results[0][f"swin_{mode}"]["logits"]
    if mode == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    same_on_every_rank(results, f"swin_{mode}", "logits")
    for r in results:
        assert r[f"swin_{mode}"]["n_correct"] == single.n_correct(
            xs, labels(4, 13))


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
    ("tp_fused", "NotImplementedError", "row-parallel"),
    ("serve_batch", "ValueError", "pad it upstream"),
    ("capture", "ValueError", "not shardable"),
])
def test_scope_errors(tp, case, kind, match):
    """3 heads over model=2, fused int8 under tensor parallelism, a
    request of 3 over data=2 and 3 calibration images over data=2."""
    for r in tp[0]:
        got = r["errors"][case]
        assert got is not None and got[0] == kind and match in got[1], got
