"""The port's serving surface against the JAX package: ``ServingEngine``
(fp32 and bf16 compute, uint8 ingest; ViT and Swin), ``Evaluator`` and
``test_classification`` without a mesh, and the integer export.

Tolerances: the fp32 engine as JAX's fused path (rtol 1e-3, atol 2e-3 of
max |logit|, tests/test_int8_serve.py:161); the bf16 engine within 5e-2 of
max |logit| (bf16 keeps 8 bits of mantissa in the float segments between
the kernels, rounded in the same places by both packages), argmax equal;
exported weights byte-equal; exported activations byte-equal on the same
captured inputs, and within one level in at most 0.1% of the elements
through each package's own capture (the forwards differ in the last ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.parallel import mesh as jmesh
from ptq4vit_tpu.parallel.serve import ServingEngine as JServingEngine
from ptq4vit_tpu.utils import integer as jint
from ptq4vit_tpu_torch import ServingEngine
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.parallel import mesh as pmesh
from ptq4vit_tpu_torch.utils import integer as pint
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (TINY, TINY_SWIN, WIDE, images,
                                      jax_net, jax_swin_net, minmax_qstate,
                                      port_net)


@pytest.fixture(scope="module")
def wide():
    jnet = jax_net(WIDE)
    x = images(4, WIDE["img_size"])
    jq = minmax_qstate(jnet, x)
    return jnet, port_net(jnet), jq, qstate_from_numpy(jq), x


def test_serving_engine_fp32_matches_jax(wide):
    jnet, pnet, jq, pq, x = wide
    ref = np.asarray(JServingEngine(jnet, jq, compute_dtype=jnp.float32)(x))
    got = ServingEngine(pnet, pq, compute_dtype=torch.float32,
                        device="cpu")(x)
    assert got.dtype == torch.float32
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                               atol=2e-3 * np.abs(ref).max())


def test_serving_engine_bf16_and_uint8_ingest(wide):
    jnet, pnet, jq, pq, x = wide
    ref = np.asarray(JServingEngine(jnet, jq)(x).astype(jnp.float32))
    eng = ServingEngine(pnet, pq, device="cpu")          # bf16 by default
    got = eng(x)
    assert got.dtype == torch.bfloat16
    assert (got.float().argmax(-1).numpy() == ref.argmax(-1)).all()
    assert np.abs(got.float().numpy() - ref).max() <= 5e-2 * np.abs(ref).max()
    # uint8 images normalized on the device from net.data_config equal the
    # same normalization done beforehand
    raw = np.random.default_rng(9).integers(
        0, 256, (2, 3, WIDE["img_size"], WIDE["img_size"])).astype(np.uint8)
    dc = pnet.data_config
    mean = np.asarray(dc.mean, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(dc.std, np.float32).reshape(1, 3, 1, 1)
    norm = ((raw.astype(np.float32) / np.float32(255.0) - mean) / std) \
        .astype(np.float32)
    u8 = ServingEngine(pnet, pq, compute_dtype=torch.float32,
                       raw_uint8=True, device="cpu")
    assert torch.equal(u8(raw), u8.net.forward(
        u8._params, torch.from_numpy(norm), pnet.cfg, qstate=pq,
        int8="fused", packed=u8._packed))
    # JAX's engine normalizes under jit, where x / 255 and / std are not
    # true divisions (ROADMAP C6): over all 768 (value, channel) inputs,
    # 615 land elsewhere than the true division at this data config
    # (0.5 / 0.5).  The engines are then held to each other on the same
    # normalized input, at the fp32 engines' tolerance
    every = np.ascontiguousarray(np.broadcast_to(
        np.arange(256, dtype=np.uint8).reshape(1, 1, 16, 16), (1, 3, 16, 16)))
    jnorm = jax.jit(lambda v: (v.astype(jnp.float32) / 255.0 - mean) / std)
    true = ((every.astype(np.float32) / np.float32(255.0) - mean) / std) \
        .astype(np.float32)
    assert (dc.mean, dc.std) == ((0.5,) * 3, (0.5,) * 3)
    assert int((np.asarray(jnorm(every)) != true).sum()) == 615
    ref = np.asarray(JServingEngine(jnet, jq, compute_dtype=jnp.float32)(norm))
    got = u8(raw).numpy()
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serving_engine_on_tiny_swin_matches_jax(dtype):
    """The port's engine runs TINY_SWIN's blocks fused (B10, B9, B11), JAX's
    its exact int8 path (heads of 6 are outside its TPU tiling): the fp32
    engines to JAX's fused tolerance, the bf16 ones within 5e-2 of max
    |logit|, argmax equal."""
    jnet = jax_swin_net(TINY_SWIN)
    x = images(4, TINY_SWIN["img_size"])
    jq = minmax_qstate(jnet, x)
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, (1e-3, 2e-3)),
                     "bf16": (jnp.bfloat16, torch.bfloat16, (0, 5e-2))}[dtype]
    ref = np.asarray(JServingEngine(jnet, jq, compute_dtype=jdt)(x)
                     .astype(jnp.float32))
    got = ServingEngine(port_net(jnet), qstate_from_numpy(jq),
                        compute_dtype=tdt, device="cpu")(x)
    assert got.dtype == tdt
    assert (got.float().argmax(-1).numpy() == ref.argmax(-1)).all()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol[0],
                               atol=tol[1] * np.abs(ref).max())


def test_serving_engine_options_not_ported(wide):
    _, pnet, _, pq, x = wide
    # a mesh is a ("data", "model") DeviceMesh since A12
    # (tests/test_torch_parallel_swin.py serves over one)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(pnet, pq, mesh=object(), device="cpu")
    # the relaxed mode serves (tests/test_torch_relaxed.py holds it to
    # JAX): the fused forward in int8="fused_relaxed", bf16 logits
    got = ServingEngine(pnet, pq, relaxed=True, device="cpu")(x)
    want = pnet.apply(torch.from_numpy(x), qstate=pq, int8="fused_relaxed",
                      packed=pack_weights(pnet.params, pq),
                      compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_evaluator_without_a_mesh_matches_jax(wide, capsys):
    jnet, pnet, jq, pq, x = wide
    y = np.random.default_rng(4).integers(0, WIDE["num_classes"], len(x))
    y[:2] = np.asarray(jnet.apply(jnp.asarray(x[:2]), qstate=jq,
                                  int8=True)).argmax(-1)
    for int8 in (False, True):
        ev = pmesh.Evaluator(pnet, pq, int8=int8)
        assert ev.n_correct(x, y) == jmesh.Evaluator(
            jnet, jq, int8=int8).n_correct(x, y)
    loader = [(x[:2], y[:2]), (x[2:], y[2:])]
    acc = pmesh.test_classification(pnet, loader, qstate=pq)
    assert acc == jmesh.test_classification(jnet, loader, qstate=jq)
    assert capsys.readouterr().out.count("\n") == 2
    assert pmesh.Evaluator(pnet, pq, int8=True).evaluate(
        loader, max_iteration=1) == 1.0
    # a mesh is a ("data", "model") DeviceMesh since A12
    # (tests/test_torch_parallel.py evaluates over one)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pmesh.Evaluator(pnet, pq, mesh=object())
    with pytest.raises(ValueError, match="needs a mesh"):
        pmesh.Evaluator(pnet, pq, tensor_parallel=True)


def test_integer_export_bytes_equal_jax():
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(4, TINY["img_size"])
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    jw, pw = jint.get_model_int_weight(jnet, jq), \
        pint.get_model_int_weight(pnet, pq)
    assert set(jw) == set(pw) and "patch_embed.proj" in pw
    for name in jw:
        assert pw[name].dtype == np.int8
        np.testing.assert_array_equal(pw[name], jw[name], err_msg=name)
    ja = jint.get_model_int_activations(jnet, jq, x, batch_size=4)
    pa = pint.get_model_int_activations(pnet, pq, x, batch_size=4)
    assert set(ja) == set(pa) and "patch_embed.proj" not in pa
    assert pa["blocks.0.mlp.fc2"]["x"].dtype == np.uint8        # twin GELU
    assert pa["blocks.0.attn.matmul2"]["a"].dtype == np.uint8   # SoS
    from ptq4vit_tpu.calib.capture import capture as jcapture
    caps = jcapture(jnet, x, batch_size=4, need_grad=False)
    for name, mtype in jnet.op_inventory:
        if name not in ja:
            continue
        # byte-equal on the same inputs
        same = pint.quantize_int_activation(
            {k: np.asarray(v) for k, v in caps[name].inputs.items()},
            pq[name], mtype)
        for k in ja[name]:
            np.testing.assert_array_equal(same[k], ja[name][k],
                                          err_msg=f"{name}.{k}")
            # through the port's own capture
            p, j = pa[name][k], ja[name][k]
            assert p.dtype == j.dtype and p.shape == j.shape
            d = np.abs(p.astype(np.int32) - j.astype(np.int32))
            if j.dtype == np.uint8:   # a level step may cross the MSB
                d = np.minimum(d, np.abs(d - 128))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
    # W6A6: the weights are skipped as the reference skips them
    assert pint.get_model_int_weight(pnet, qstate_from_numpy(
        minmax_qstate(jnet, x, 6))) == {}
