"""A calibration at ViT-L/384's width against the JAX package.

ViT-L/384's width and heads (embed 1024, 16 heads of 64, a 4096-wide MLP)
at depth 1 and a small image, on 2 images: the port's ``quantize``
against the JAX ``HessianQuantCalibrator`` with the JAX probe noise, eq_n
8, one round.  Intervals must be equal (rtol 1e-5)
or both picks proven fp-degenerate argmax ties by the f64 oracles of
tests/test_reference_goldens.py.  The full-size rows are held to the JAX
package's in tests/test_torch_scratch.py; Swin-L/384's width in
tests/test_torch_large_swin.py.
"""
import jax
import numpy as np

import ptq4vit_tpu_torch
from ptq4vit_tpu.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from tests.torch_port_helpers import (assert_qstate_matches, bits_meta,
                                      golden_view, images, jax_net,
                                      jax_probe_u, np_fields, port_net,
                                      shrink)

# ViT-L/384's width and heads at depth 1: 5 tokens of 1024
VIT_L_WIDTH = dict(img_size=32, patch_size=16, embed_dim=1024, depth=1,
                   num_heads=16, num_classes=10)
PROBE_SEED = 3


def check_quantize_matches_jax(jnet, shape):
    """The port's quantize against the JAX HessianQuantCalibrator with the
    JAX probe noise, 2 images, eq_n 8, one round."""
    pnet = port_net(jnet)
    x = images(2, 32)
    jcfg = shrink(jptq4vit())
    jq = HessianQuantCalibrator(jnet, jcfg, x, batch_size=2,
                                probe_seed=PROBE_SEED) \
        .batching_quant_calib(verbose=False)
    _, pq = ptq4vit_tpu_torch.quantize(
        pnet, x, config=shrink(pptq4vit()), batch_size=2, device="cpu",
        probe_u=jax_probe_u(2, shape["num_classes"], PROBE_SEED))
    assert set(pq) == set(jq) == {n for n, _ in jnet.op_inventory}
    caps = jcapture(jnet, x, batch_size=2, need_grad=True,
                    probe_seed=PROBE_SEED)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    shape["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, shape["patch_size"]),
                          jnet.op_inventory, kws)


def test_vit_l_width_quantize_matches_jax():
    check_quantize_matches_jax(jax_net(VIT_L_WIDTH), VIT_L_WIDTH)
