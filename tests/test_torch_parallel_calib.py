"""Mesh calibration of the port on gloo ranks of the CPU: the tiny ViT over
data=2 and data=4, parallel and sequential, plain and kernel-route scorers
with int8 scoring off and on, the capture's probe gradients, a resumed
mesh calibration and the search variants JAX's mesh runs through (pearson,
block grids, layerwise inits, the sub-layerwise and quantile convs).

Every rank's qstate must be the same bytes; each is held to the port's
single-device qstate (rtol 1e-5, tests/test_parallel.py's tolerance) and,
for the JAX package's own cases, to JAX's ``make_mesh`` calibration in
this process (every slot within rtol 1e-5 or an f64 tie, as
tests/test_torch_pipeline.py holds the single devices)."""
import jax
import numpy as np
import pytest

from ptq4vit_tpu.calib.calibrator import \
    HessianQuantCalibrator as JCalibrator
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.parallel import make_mesh as jmake_mesh
from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu_torch.calib.capture import capture
from tests import torch_mesh_workers as W
from tests.torch_port_helpers import (TINY, assert_qstate_matches, bits_meta,
                                      golden_view, images, jax_net,
                                      jax_probe_u, np_fields, port_net,
                                      shrink)

PROBE_SEED = 3
PTQ4VIT = ("PTQ4ViT", 8, 1, (8, 8))
# the search paths of the ablation surface, each through its own
# reductions over the samples
PEARSON_BLOCKED = ("PTQ4ViT", 6, 1, (8, 8), {
    "linear": {"metric": "pearson", "n_V": 2, "n_H": 2, "n_a": 2},
    "matmul": {"metric": "L2_norm", "n_V_A": 2, "n_H_B": 2},
    "conv": {"metric": "L2_norm", "n_V": 2, "n_H": 2},
    "attrs": {"conv_quantizer": "conv_ptqsl"}})
LAYERWISE = ("BasePTQ", 6, 2, (6, 6), {
    "linear": {"init_layerwise": True},
    "matmul": {"init_layerwise": True, "metric": "L1_norm"},
    "attrs": {"conv_quantizer": "conv_quantile"}})
PORT_CASES = {
    "vit": (PTQ4VIT, {}),
    "kernels_exact": (PTQ4VIT, {"use_kernels": True, "int8_score": False}),
    "kernels_int8": (PTQ4VIT, {"use_kernels": True, "int8_score": True}),
    "sequential": (PTQ4VIT, {"sequential": True}),
    "pearson_blocked": (PEARSON_BLOCKED, {"batch_size": 4}),
    "layerwise": (LAYERWISE, {"batch_size": 4}),
    "conv_search": (("BasePTQ", 6, 1, (8, 8)), {"batch_size": 4}),
}
# the JAX package's settings of the same cases (tests/test_parallel.py)
JAX_ENV = {"vit": {}, "kernels_exact": {"PTQ4VIT_TPU_PALLAS": "1"},
           "kernels_int8": {"PTQ4VIT_TPU_PALLAS": "1",
                            "PTQ4VIT_TPU_INT8_SCORE": "1"},
           "sequential": {}}


@pytest.fixture(scope="module")
def setup():
    jnet = jax_net(TINY)
    return jnet, W.net_spec(jnet), images(8, 32), jax_probe_u(8, 10,
                                                              PROBE_SEED)


def calib_task(spec, x, u, config, kw):
    return dict(task="calib", net=spec, x=x, config=config,
                kw=dict({"batch_size": 8, "probe_u": u}, **kw))


@pytest.fixture(scope="module")
def dp2(setup, tmp_path_factory):
    jnet, spec, x, u = setup
    ck = str(tmp_path_factory.mktemp("ck"))
    tasks = {k: calib_task(spec, x, u, cfg, kw)
             for k, (cfg, kw) in PORT_CASES.items()}
    head = {n: t for n, t in jnet.op_inventory[:7]}
    tasks["resume_part"] = calib_task(spec, x, u, PTQ4VIT, {
        "checkpoint_dir": ck, "wrapped_modules": head})
    tasks["resume_full"] = calib_task(spec, x, u, PTQ4VIT,
                                      {"checkpoint_dir": ck})
    tasks["capture"] = dict(task="capture", net=spec, x=x, batch_size=8,
                            probe_u=u, ops=["blocks.0.attn.qkv",
                                            "blocks.1.attn.matmul2"])
    return W.run_job(tmp_path_factory.mktemp("dp2"), 2, tasks)


@pytest.fixture(scope="module")
def dp4(setup, tmp_path_factory):
    _, spec, x, u = setup
    return W.run_job(tmp_path_factory.mktemp("dp4"), 4, {
        "vit": calib_task(spec, x, u, PTQ4VIT, {})})


@pytest.fixture(scope="module")
def single(setup):
    """The port on one device, every case."""
    jnet, spec, x, u = setup
    out = {}
    for k, (cfg, kw) in PORT_CASES.items():
        kw = dict({"batch_size": 8, "probe_u": u}, **kw)
        out[k] = W.qstate_to_np(HessianQuantCalibrator(
            port_net(jnet), W.quant_config(cfg), x, device="cpu",
            **kw).batching_quant_calib())
    return out


def jax_mesh_qstate(jnet, x, n, case, monkeypatch):
    for k, v in JAX_ENV[case].items():
        monkeypatch.setenv(k, v)
    # the per-op sequential captures: the shared plan's qstate, a third of
    # its compile time here
    monkeypatch.setenv("PTQ4VIT_TPU_SEQ_SHARED", "0")
    return JCalibrator(jnet, shrink(jptq4vit()), x, batch_size=8,
                       sequential=case == "sequential",
                       probe_seed=PROBE_SEED, mesh=jmake_mesh(n)) \
        .batching_quant_calib(verbose=False)


def assert_matches_jax(pq, jq, jnet, x, case):
    """Every slot within rtol 1e-5 of JAX's, or both picks f64 ties
    (``assert_qstate_matches``); sequential qstates slot for slot."""
    mods = {n: np_fields(q) for n, q in jq.items()}
    port = W.qstate_from_np(pq)
    if case == "sequential":
        for n in mods:
            for k, v in np_fields(port[n]).items():
                np.testing.assert_allclose(v.reshape(-1),
                                           mods[n][k].reshape(-1),
                                           rtol=1e-5, err_msg=f"{n}.{k}")
        return
    jcfg = shrink(jptq4vit())
    caps = jcapture(jnet, x, batch_size=8, need_grad=True,
                    probe_seed=PROBE_SEED)
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    TINY["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(port, mods, z, bits_meta(jcfg, TINY["patch_size"]),
                          jnet.op_inventory, kws)


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_mesh_calibration_matches_single_device(dp2, single, case):
    """tests/test_parallel.py test_mesh_calibration_matches_single_device,
    test_mesh_pallas_scorers_match_single_device and
    test_mesh_sequential_matches_single_device on the port, int8 scoring
    too, and the ablation surface's search paths."""
    W.assert_rank_identical(dp2, case)
    W.assert_same_qstates(dp2[0][case]["qstate"], single[case])


def test_mesh_calibration_over_four_ranks(dp4, single):
    W.assert_rank_identical(dp4, "vit")
    W.assert_same_qstates(dp4[0]["vit"]["qstate"], single["vit"])


@pytest.mark.parametrize("case,world", [
    ("vit", 2), ("vit", 4), ("kernels_exact", 2), ("kernels_int8", 2),
    ("sequential", 2)])
def test_mesh_calibration_matches_jax_mesh(setup, dp2, dp4, case, world,
                                           monkeypatch):
    jnet, _, x, _ = setup
    jq = jax_mesh_qstate(jnet, x, world, case, monkeypatch)
    results = dp2 if world == 2 else dp4
    assert_matches_jax(results[0][case]["qstate"], jq, jnet, x, case)


def test_mesh_capture_matches_host(setup, dp2):
    """tests/test_parallel.py test_sharded_capture_matches_host: the ranks'
    inputs and probe gradients, gathered in sample order, equal the
    single-device capture's and JAX's (rtol 1e-4, atol 1e-7)."""
    jnet, _, x, u = setup
    host = capture(port_net(jnet), x, batch_size=8, need_grad=True,
                   probe_u=u)
    jhost = jcapture(jnet, x, batch_size=8, need_grad=True,
                     probe_seed=PROBE_SEED)
    for r in dp2:
        for op, got in r["capture"].items():
            cap, jcap = host[op], jhost[op]
            field = "x" if "x" in cap.inputs else "a"
            np.testing.assert_allclose(got[field],
                                       cap.inputs[field].numpy(),
                                       rtol=1e-4, atol=1e-7)
            for want in (cap.grad.numpy(), np.asarray(jcap.grad)):
                np.testing.assert_allclose(got["grad"], want, rtol=1e-4,
                                           atol=1e-7, err_msg=op)


def test_mesh_resume_equals_uninterrupted(setup, dp2):
    """A mesh calibration resumed from a checkpoint directory that holds
    the first seven ops searches only the rest and ends with the
    uninterrupted mesh run's qstate."""
    jnet = setup[0]
    names = [n for n, _ in jnet.op_inventory]
    for r in dp2:
        assert r["resume_part"]["searched"] == sorted(names[:7])
        assert r["resume_full"]["searched"] == sorted(names[7:])
    W.assert_rank_identical(dp2, "resume_full")
    W.assert_same_qstates(dp2[0]["resume_full"]["qstate"],
                        dp2[0]["vit"]["qstate"], rtol=0)
