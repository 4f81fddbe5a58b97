"""The tiny Swin's mesh calibration and data-parallel serving of the port
on gloo ranks of the CPU (tests/test_parallel.py's Swin and serving
cases): the Swin calibrated over data=2 with plain and kernel-route
scorers (the head-folded window-matmul scorer, B3f's plain version),
int8 scoring off and on, parallel and sequential; ``ServingEngine(mesh=)``
on the tiny ViT, the tiny Swin and a Swin whose heads of 64 take the fused
window blocks.  Qstates are the same bytes on every rank and within rtol
1e-5 of the port's single device and of JAX's ``make_mesh`` run.  The
gathered serving logits are the port's single device's bitwise (within
JAX's rtol 1e-5, atol 1e-5 * max|logit|), and JAX's mesh engine's within
the tolerance that holds the two packages' single-device engines
(tests/test_torch_serve.py: rtol 1e-3, atol 2e-3 * max|logit|, argmax
equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.calibrator import \
    HessianQuantCalibrator as JCalibrator
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.parallel import ServingEngine as JServingEngine
from ptq4vit_tpu.parallel import make_mesh as jmake_mesh
from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu_torch.parallel import ServingEngine
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests import torch_mesh_workers as W
from tests.torch_port_helpers import (TINY, TINY_SWIN, WIDE_SWIN, images,
                                      jax_net, jax_probe_u, jax_swin_net,
                                      minmax_qstate, np_fields, port_net,
                                      shrink)

PROBE_SEED = 3
PTQ4VIT = ("PTQ4ViT", 8, 1, (8, 8))
CASES = {
    "swin": {},
    "kernels_exact": {"use_kernels": True, "int8_score": False},
    "kernels_int8": {"use_kernels": True, "int8_score": True},
    "sequential": {"sequential": True},
}
JAX_ENV = {"swin": {}, "kernels_exact": {"PTQ4VIT_TPU_PALLAS": "1"}}
# the nets served, with the images (and min-max qstates) on which
# tests/test_torch_serve.py and tests/test_torch_int8_serve_swin_block.py
# hold the packages' single-device engines to each other
SERVE_NETS = {"vit": (jax_net, TINY, 4), "swin": (jax_swin_net, TINY_SWIN, 4),
              "swin_window_kernels": (jax_swin_net, WIDE_SWIN, 2)}


@pytest.fixture(scope="module")
def setup():
    jnet = jax_swin_net(TINY_SWIN)
    serve = {}
    for k, (make, shape, n) in SERVE_NETS.items():
        net, xs = make(shape), images(n, 32)
        serve[k] = (net, minmax_qstate(net, xs), xs)
    return (jnet, W.net_spec(jnet), images(8, 32),
            jax_probe_u(8, TINY_SWIN["num_classes"], PROBE_SEED), serve)


@pytest.fixture(scope="module")
def dp2(setup, tmp_path_factory):
    jnet, spec, x, u, serve = setup
    tasks = {k: dict(task="calib", net=spec, x=x, config=PTQ4VIT,
                     kw=dict({"batch_size": 8, "probe_u": u}, **kw))
             for k, kw in CASES.items()}
    for k, (net, q, xs) in serve.items():
        tasks[f"serve_{k}"] = dict(
            task="serve", net=W.net_spec(net), x=xs,
            qstate=W.qstate_to_np(qstate_from_numpy(q)))
    return W.run_job(tmp_path_factory.mktemp("dp2"), 2, tasks)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_swin_calibration_matches_single_device(setup, dp2, case):
    """test_mesh_swin_calibration_matches_single_device and
    test_mesh_swin_pallas_scorers_match_single_device on the port."""
    jnet, _, x, u, _ = setup
    want = W.qstate_to_np(HessianQuantCalibrator(
        port_net(jnet), W.quant_config(PTQ4VIT), x, batch_size=8,
        device="cpu", probe_u=u, **CASES[case]).batching_quant_calib())
    W.assert_rank_identical(dp2, case)
    W.assert_same_qstates(dp2[0][case]["qstate"], want)


@pytest.mark.parametrize("case", list(JAX_ENV))
def test_mesh_swin_calibration_matches_jax_mesh(setup, dp2, case,
                                                monkeypatch):
    jnet, _, x, _, _ = setup
    for k, v in JAX_ENV[case].items():
        monkeypatch.setenv(k, v)
    jq = JCalibrator(jnet, shrink(jptq4vit()), x, batch_size=8,
                     probe_seed=PROBE_SEED, mesh=jmake_mesh(2)) \
        .batching_quant_calib(verbose=False)
    got = W.qstate_from_np(dp2[0][case]["qstate"])
    for n, qp in jq.items():
        for k, v in np_fields(qp).items():
            np.testing.assert_allclose(np_fields(got[n])[k].reshape(-1),
                                       v.reshape(-1), rtol=1e-5,
                                       err_msg=f"{n}.{k}")


@pytest.mark.parametrize("net", list(SERVE_NETS))
def test_mesh_fused_serving_matches_single_device(setup, dp2, net):
    """test_mesh_fused_serving_matches_single_device,
    test_mesh_swin_fused_serving_matches_single_device and
    test_mesh_swin_window_kernels_engage: the rows are independent, so the
    gathered logits are the single device's bitwise; the fused Swin blocks
    run on both sides at heads of 64."""
    jnet, q, xs = setup[4][net]
    pq = qstate_from_numpy(q)
    single = ServingEngine(port_net(jnet), pq, compute_dtype=torch.float32,
                           device="cpu")(xs).numpy()
    jmesh = np.asarray(JServingEngine(jnet, q, mesh=jmake_mesh(2),
                                      compute_dtype=jnp.float32)(xs))
    for r in dp2:
        got = r[f"serve_{net}"]
        np.testing.assert_array_equal(got["logits"], single)
        assert (got["logits"].argmax(-1) == jmesh.argmax(-1)).all()
        np.testing.assert_allclose(got["logits"], jmesh, rtol=1e-3,
                                   atol=2e-3 * np.abs(jmesh).max())
        if net == "swin_window_kernels":
            assert got["fused_swin_blocks"] > 0
