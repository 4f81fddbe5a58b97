"""Port ViT forward against the JAX package's ``net.apply`` with the same
params (carried across with params_from_numpy): raw logits, and
fake-quant logits under a JAX qstate converted with qstate_from_numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.quant import fakequant as jfq
from ptq4vit_tpu.quant.qparams import ConvQP, LinearQP, MatMulQP
from ptq4vit_tpu_torch.models import MODEL_ZOO, get_net, model_config
from ptq4vit_tpu_torch.models.vit import op_inventory as port_inventory
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (TINY, WIDE, assert_logits_close,
                                      images, jax_net, port_net)


def minmax_jax_qstate(jnet, x):
    """A JAX qstate with every main-path quantizer kind (channelwise conv,
    n_V = 3 qkv, twin post-GELU fc2, head-wise matmul1, SoS matmul2), its
    intervals from min-max over a capture."""
    caps = jcapture(jnet, x, batch_size=len(x), need_grad=False)
    q = {}
    for name, mtype in jnet.op_inventory:
        cap = caps[name]
        if mtype == "qconv":
            w = np.asarray(jnet.params["patch_embed"]["proj"]["weight"])
            wi = np.abs(w).reshape(w.shape[0], -1).max(1) / 127.5
            q[name] = ConvQP(w_interval=jnp.asarray(
                wi.reshape(-1, 1, 1, 1), jnp.float32))
        elif "qmatmul" in mtype:
            G = cap.inputs["a"].shape[1]
            bi = jfq.matmul_operand_interval_init(
                jnp.asarray(cap.inputs["b"]), G, 1, 1, 128)
            if mtype == "qmatmul_scorev":
                split = jnp.float32(2.0 ** -5)
                q[name] = MatMulQP(A_interval=split / 127, B_interval=bi,
                                   split=split)
            else:
                q[name] = MatMulQP(A_interval=jfq.matmul_operand_interval_init(
                    jnp.asarray(cap.inputs["a"]), G, 1, 1, 128),
                    B_interval=bi)
        else:
            node = jnet.params
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, list) else node[part]
            n_V = 3 if mtype == "qlinear_qkv" else 1
            pg = mtype == "qlinear_MLP_2"
            x_in = jnp.asarray(cap.inputs["x"])
            q[name] = LinearQP(
                w_interval=jfq.blocked_weight_interval_init(
                    node["weight"], n_V, 1, 128),
                a_interval=jfq.grouped_act_interval_init(x_in, 1, 128,
                                                         signed=not pg),
                a_neg_interval=(jnp.float32(jfq.GELU_NEG_CLIP / 128)
                                if pg else None),
                postgelu=pg)
    return q


@pytest.mark.parametrize("shape", [TINY, WIDE], ids=["tiny", "wide"])
def test_raw_logits_match_jax(shape):
    jnet = jax_net(shape)
    pnet = port_net(jnet)
    x = images(4, shape["img_size"])
    assert_logits_close(pnet.apply(torch.from_numpy(x)),
                        jnet.apply(jnp.asarray(x)), raw=True)
    assert pnet.op_inventory == jnet.op_inventory


@pytest.mark.parametrize("shape", [TINY, WIDE], ids=["tiny", "wide"])
def test_fake_quant_logits_match_jax(shape):
    jnet = jax_net(shape)
    pnet = port_net(jnet)
    x = images(4, shape["img_size"])
    jq = minmax_jax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    assert pq["blocks.0.mlp.fc2"].postgelu
    assert pq["blocks.0.attn.matmul2"].split is not None
    ql = pnet.apply(torch.from_numpy(x), qstate=pq)
    assert_logits_close(ql, jnet.apply(jnp.asarray(x), qstate=jq))
    # the quantizers are live: the logits moved off the fp32 ones
    assert not torch.equal(ql, pnet.apply(torch.from_numpy(x)))


def test_capture_taps_and_eps_probe():
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = torch.from_numpy(images(2, 32))
    eps = {"blocks.0.attn.qkv": torch.zeros(2, 17, 72, requires_grad=True)}
    logits, taps = pnet.apply(x, eps=eps, capture=True)
    assert set(taps) == {n for n, _ in pnet.op_inventory}
    assert taps["patch_embed.proj"]["x"].shape == (2, 16, 3 * 8 * 8)
    assert taps["blocks.1.attn.matmul1"]["b"].shape == (2, 3, 8, 17)
    (g,) = torch.autograd.grad(logits.sum(), [eps["blocks.0.attn.qkv"]])
    assert g.shape == (2, 17, 72) and g.abs().max() > 0


def test_registry_matches_jax_zoo():
    from ptq4vit_tpu.models import registry as jreg
    # the port's rows are the JAX package's, and its own Swin V2
    assert {k: v for k, v in MODEL_ZOO.items()
            if v["kind"] != "swinv2"} == jreg.MODEL_ZOO
    cfg = model_config("vit_base_patch16_384")
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.seq_len) == \
        (768, 12, 12, 577)
    net = get_net("vit_tiny_patch16_224", seed=0, device="cpu")
    assert net.op_inventory == port_inventory(net.cfg)
    assert net.params["blocks"][0]["mlp"]["fc1"]["weight"].shape == (768, 192)
    # the Swin rows build Swin nets (tests/test_torch_swin.py holds them
    # against JAX); unknown names still raise
    swin = get_net("swin_tiny_patch4_window7_224", device="cpu")
    assert swin.op_inventory == jreg.swin_mod.op_inventory(
        jreg.model_config("swin_tiny_patch4_window7_224"))
    assert swin.params["layers"][0]["downsample"]["reduction"]["weight"] \
        .shape == (192, 384)
    with pytest.raises(NotImplementedError):
        get_net("swin_huge")


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``get_net`` and ``quantize`` run on the card when no device is
    given; with no card they raise instead of running on the CPU."""
    import ptq4vit_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_net("vit_tiny_patch16_224")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptq4vit_tpu_torch.quantize("vit_tiny_patch16_224",
                                   np.zeros((1, 3, 224, 224), np.float32))
    net = get_net("vit_tiny_patch16_224", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptq4vit_tpu_torch.quantize(net, np.zeros((1, 3, 224, 224),
                                                 np.float32))
    assert net.params["head"]["weight"].device.type == "cpu"
