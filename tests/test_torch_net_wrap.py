"""The port's op-selection helpers (``ptq4vit_tpu_torch/models/net_wrap.py``)
against the JAX package's (``ptq4vit_tpu/models/net_wrap.py``): the same
dicts, in the same order, for the tiny ViT and the tiny Swin, and the same
BN fold."""
import numpy as np
import pytest
import torch

from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.models import net_wrap as J
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.models import net_wrap as P
from tests.torch_port_helpers import (SWIN3, TINY, jax_net, jax_swin_net,
                                      port_net)

LEAVES = sorted(J.MODULE_TYPES)


@pytest.fixture(scope="module")
def nets():
    out = {}
    for kind, jnet in (("vit", jax_net(TINY)), ("swin", jax_swin_net(SWIN3))):
        out[kind] = (jnet, port_net(jnet))
    return out


def test_module_types_are_jax_s():
    assert P.MODULE_TYPES == J.MODULE_TYPES


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_wrap_modules_in_net_matches_jax(nets, kind):
    jnet, pnet = nets[kind]
    got = P.wrap_modules_in_net(pnet, pptq4vit())
    assert list(got.items()) == list(J.wrap_modules_in_net(
        jnet, jptq4vit()).items())
    assert list(got.items()) == list(pnet.op_inventory)


@pytest.mark.parametrize("wrap_embedding", [False, True])
@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_wrap_certain_modules_matches_jax(nets, kind, wrap_embedding):
    """Every block subset of 0, 1 and 2 blocks, with each module-kind set
    of a sample (one leaf, the attention's, all of them)."""
    jnet, pnet = nets[kind]
    for layers in ([], [0], [1], [0, 1]):
        for leaves in (["qkv"], ["fc2", "matmul2"],
                       ["qkv", "proj", "matmul1", "matmul2"], LEAVES):
            kw = dict(layers=layers, modules_to_wrap=leaves,
                      wrap_embedding=wrap_embedding)
            got = P.wrap_certain_modules_in_net(pnet, pptq4vit(), **kw)
            ref = J.wrap_certain_modules_in_net(jnet, jptq4vit(), **kw)
            assert list(got.items()) == list(ref.items()), kw
            assert ("patch_embed.proj" in got) == wrap_embedding


def test_swin_subset_keys_on_the_block_index(nets):
    """layers.<stage>.blocks.<idx>: block 1 of both stages, not stage 1."""
    _, pnet = nets["swin"]
    got = P.wrap_certain_modules_in_net(pnet, pptq4vit(), layers=[1],
                                        modules_to_wrap=["qkv"])
    assert list(got) == ["layers.0.blocks.1.attn.qkv",
                         "layers.1.blocks.1.attn.qkv"]


def test_reference_wrap_order_matches_jax(nets):
    for jnet, _ in nets.values():
        assert P.reference_wrap_order(jnet.op_inventory) == \
            J.reference_wrap_order(jnet.op_inventory)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("conv_bias", [True, False])
def test_fold_bn_into_conv_matches_jax(rng, affine, conv_bias):
    """The fold on tensors against JAX's on the same numpy inputs (rtol
    1e-6, atol 1e-7: the same float32 formula, XLA may fuse it)."""
    oc, ic = 6, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    conv = {"weight": f(oc, ic, 3, 3)}
    if conv_bias:
        conv["bias"] = f(oc)
    bn = {"running_mean": f(oc),
          "running_var": np.abs(f(oc)) + np.float32(0.1)}
    if affine:
        bn.update(weight=f(oc), bias=f(oc))
    ref = J.fold_bn_into_conv(conv, bn, eps=1e-5)
    got = P.fold_bn_into_conv({k: torch.from_numpy(v) for k, v in
                               conv.items()},
                              {k: torch.from_numpy(v) for k, v in bn.items()},
                              eps=1e-5)
    for k in ("weight", "bias"):
        assert torch.is_tensor(got[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
