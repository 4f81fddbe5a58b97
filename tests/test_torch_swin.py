"""The port's Swin against the JAX package's, on the tiny Swin of
tests/test_models.py (and an odd-head twin): raw logits, capture taps and
caches (shapes, order, values), fake-quant logits under a JAX qstate, the
timm state_dict ingestion, the registry rows and the cache-size count the
calibrator groups ops by.  JAX runs on the CPU; params cross over with
params_from_numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.models import registry as jreg
from ptq4vit_tpu.utils import timm_port as jtp
from ptq4vit_tpu_torch.calib.calibrator import (kernel_scratch_bytes,
                                                tap_bytes)
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.calib.capture import capture as pcapture
from ptq4vit_tpu_torch.models import get_net, model_config, net_from_config
from ptq4vit_tpu_torch.models import swin as pswin
from ptq4vit_tpu_torch.utils import timm_port as ptp
from ptq4vit_tpu_torch.utils.convert import (params_from_numpy,
                                             qstate_from_numpy)
from tests import test_reference_goldens as G
from tests.test_torch_models import minmax_jax_qstate
from tests.torch_port_helpers import (SWIN3, TINY_SWIN, assert_logits_close,
                                      images, jax_probe_u, jax_swin_net,
                                      port_net)

SHAPES = pytest.mark.parametrize("shape", [TINY_SWIN, SWIN3],
                                 ids=["tiny", "odd_heads"])


def close(p, j, what, rtol=1e-5):
    p = p.detach().numpy() if torch.is_tensor(p) else np.asarray(p)
    j = np.asarray(j)
    assert p.shape == j.shape, what
    np.testing.assert_allclose(p, j, rtol=rtol, atol=1e-6 * np.abs(j).max(),
                               err_msg=what)


@SHAPES
def test_swin_raw_logits_match_jax(shape):
    jnet = jax_swin_net(shape)
    pnet = port_net(jnet)
    x = images(4, 32)
    assert_logits_close(pnet.apply(torch.from_numpy(x)),
                        jnet.apply(jnp.asarray(x)), raw=True)
    assert pnet.op_inventory == jnet.op_inventory
    assert pnet.op_shapes == jnet.op_shapes


@SHAPES
def test_swin_taps_match_jax(shape):
    """Every tap in the same order with the same shapes and values; the
    matmul1 tap's A is the pre-scaled q; window taps are images-major."""
    jnet = jax_swin_net(shape)
    pnet = port_net(jnet)
    x = images(2, 32)
    _, ptaps = pnet.apply(torch.from_numpy(x), capture=True)
    _, jtaps = jnet.apply(jnp.asarray(x), capture=True)
    assert list(ptaps) == list(jtaps) == [n for n, _ in jnet.op_inventory]
    for name in ptaps:
        assert set(ptaps[name]) == set(jtaps[name]), name
        for field in ptaps[name]:
            close(ptaps[name][field], jtaps[name][field], f"{name}.{field}")
    heads = shape["num_heads"][0]
    a = ptaps["layers.0.blocks.1.attn.matmul1"]["a"]
    assert a.shape == (2 * 16, heads, 16, 12 // heads)   # 2 images x 16 win
    # q is pre-scaled: A @ B is the tap's output before bias and mask
    out = ptaps["layers.0.blocks.1.attn.matmul1"]["out"]
    torch.testing.assert_close(
        a @ ptaps["layers.0.blocks.1.attn.matmul1"]["b"], out)


def test_swin_capture_caches_match_jax():
    """The parallel capture (inputs, outputs, probe gradients) of every op
    against the JAX capture with the same probe noise: the window-matmul
    caches keep the (images x windows)-major sample order across
    micro-batches."""
    jnet = jax_swin_net(TINY_SWIN)
    pnet = port_net(jnet)
    x = images(4, 32)
    jc = jcapture(jnet, x, batch_size=2, need_grad=True, probe_seed=5,
                  probe_sigma=1e-1)
    pc = pcapture(pnet, x, batch_size=2, need_grad=True,
                  probe_u=jax_probe_u(4, 7, 5), probe_sigma=1e-1)
    assert list(pc) == list(jc)
    for n in pc:
        for k in pc[n].inputs:
            close(pc[n].inputs[k], jc[n].inputs[k], f"{n}.{k}", rtol=1e-4)
        close(pc[n].out, jc[n].out, f"{n}.out", rtol=1e-4)
        close(pc[n].grad, jc[n].grad, f"{n}.grad", rtol=1e-4)
    assert pc["layers.1.blocks.1.attn.matmul2"].inputs["a"].shape == \
        (4 * 4, 4, 16, 16)


@SHAPES
def test_swin_fake_quant_logits_match_jax(shape):
    """Each op fake-quantized alone, then all at once, under a JAX qstate.
    Alone, each op's logits are within assert_logits_close (a last-ulp
    difference upstream can flip one level: ~1e-4 of max|logit|).  All at
    once the flips compound through the 27 quantizers of the net (5.4e-3 of
    max|logit| measured on the odd-head net), so the whole-qstate logits
    are held to 1e-2 of max|logit|."""
    jnet = jax_swin_net(shape)
    pnet = port_net(jnet)
    x = images(4, 32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    jq = minmax_jax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    assert pq["layers.0.blocks.0.mlp.fc2"].postgelu
    assert pq["layers.1.blocks.1.attn.matmul2"].split is not None
    for name, _ in jnet.op_inventory:
        assert_logits_close(pnet.apply(xt, qstate={name: pq[name]}),
                            jnet.apply(xj, qstate={name: jq[name]}))
    ql = pnet.apply(xt, qstate=pq).numpy()
    jl = np.asarray(jnet.apply(xj, qstate=jq))
    assert np.abs(ql - jl).max() <= 1e-2 * np.abs(jl).max()
    assert not np.array_equal(ql, pnet.apply(xt).numpy())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def assert_same_tree(port, jax_tree):
    a, b = dict(_leaves(port)), dict(_leaves(jax_tree))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("cell", ["ref_tinyswin_PTQ4ViT_w8a8_hessian",
                                  "ref_tinyswin3_PTQ4ViT_w8a8_hessian"])
def test_swin_state_dict_ingestion_matches_jax(cell):
    """The golden's timm state_dict through the port's timm_port equals the
    JAX conversion, and the port net built from it gives the reference's
    raw logits."""
    z, meta, sd, _ = G._load(f"{G.GOLDEN_DIR}/{cell}.npz")
    jnet = G._build_net(meta, sd)
    cfg = pswin.SwinConfig(**{k: getattr(jnet.cfg, k) for k in
                              ("name", "img_size", "patch_size", "embed_dim",
                               "depths", "num_heads", "window_size",
                               "num_classes", "ln_eps")})
    params = ptp.swin_params_from_state_dict(dict(sd), cfg)
    assert_same_tree(params, jtp.swin_params_from_state_dict(dict(sd),
                                                             jnet.cfg))
    pnet = net_from_config(cfg, params_from_numpy(params))
    for key, ref in (("calib_x", "raw_logits"), ("eval_x", "raw_logits_eval")):
        got = pnet.apply(torch.from_numpy(z[key])).numpy()
        np.testing.assert_allclose(got, z[ref], rtol=1e-4, atol=1e-4)


def test_vit_state_dict_ingestion_matches_jax():
    """The distilled-DeiT ingestion golden through both packages."""
    z = np.load(f"{G.GOLDEN_DIR}/ref_tinydeit_ingest.npz")
    c = G.json.loads(str(z["__meta__"]))["cfg"]
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    jcfg = G.vit_mod.ViTConfig(name="deit", img_size=c["img_size"],
                               patch_size=c["patch_size"],
                               embed_dim=c["embed_dim"], depth=c["depth"],
                               num_heads=c["num_heads"],
                               num_classes=c["num_classes"],
                               ln_eps=c["ln_eps"], distilled=True)
    assert_same_tree(ptp.vit_params_from_state_dict(dict(sd), jcfg),
                     jtp.vit_params_from_state_dict(dict(sd), jcfg))
    with pytest.raises(ValueError):
        ptp.vit_params_from_state_dict(dict(sd, extra=np.zeros(1)), jcfg)


def test_params_from_state_dict_by_zoo_name():
    """A zoo Swin's state_dict (timm key names, with the static buffers
    timm stores) round-trips through params_from_state_dict as in JAX."""
    name = "swin_tiny_patch4_window7_224"
    net = get_net(name, seed=4, device="cpu")
    sd = dict(_leaves(net.params))
    sd["layers.0.blocks.0.attn.relative_position_index"] = np.zeros((49, 49))
    sd["layers.0.blocks.1.attn_mask"] = np.zeros((64, 49, 49))
    params = ptp.params_from_state_dict(name, sd)
    assert_same_tree(params, jax.tree.map(
        np.asarray, jtp.params_from_state_dict(name, dict(sd))))
    assert_same_tree(params, net.params)
    assert get_net(name, params=params, device="cpu").params["head"]["weight"].shape == \
        (1000, 768)


def test_swin_registry_matches_jax():
    for name, z in jreg.MODEL_ZOO.items():
        if z["kind"] != "swin":
            continue
        cfg = model_config(name)
        assert isinstance(cfg, pswin.SwinConfig)
        jcfg = jreg.model_config(name)
        assert pswin.op_inventory(cfg) == jreg.swin_mod.op_inventory(jcfg)
        assert pswin.op_shapes(cfg) == jreg.swin_mod.op_shapes(jcfg)
    cfg = model_config("swin_base_patch4_window12_384")
    assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size,
            cfg.img_size) == (128, (2, 2, 18, 2), (4, 8, 16, 32), 12, 384)
    inv = pswin.op_inventory(cfg)
    assert len(inv) == 149 == 1 + 24 * 6 + 3 + 1
    info = pswin.op_shapes(cfg)["layers.0.blocks.0.attn.matmul1"]
    assert (info["heads"], info["rows"], info["inner"], info["windows"]) == \
        (4, 144, 32, 64)


def test_tap_bytes_counts_window_caches():
    """tap_bytes equals the bytes of the tiny Swin's captured tensors, the
    window matmuls' (images x windows) samples included."""
    pnet = port_net(jax_swin_net(TINY_SWIN))
    x = images(4, 32)
    caps = pcapture(pnet, x, batch_size=2, need_grad=True)
    sizes = tap_bytes(pnet, 4, True, True, 4)
    assert set(sizes) == set(caps)
    for n, cap in caps.items():
        elems = sum(v.numel() for v in cap.inputs.values()) \
            + cap.out.numel() + cap.grad.numel()
        assert sizes[n] == 4 * elems, n
    assert pnet.op_shapes["layers.0.blocks.0.attn.matmul1"]["windows"] == 16


def test_kernel_scratch_bytes_at_swin_b384():
    """The level buffers the calibrator reserves beside a group's caches:
    the per-candidate input levels of B2 and B4a at stage-1 fc2 dominate
    (eq_n x M x K-padded ic bytes, M = 9216 tokens x images), B4a's with
    its fp32 fake-quant weight (oc x ic x 4 bytes) beside them; the SoS
    matmul2 runs only mode b_sos, with B3f's per-warp partial sums (4
    bytes x P x heads x windows-samples x 3 x 1 tiles x 8 warps)."""
    cfg = model_config("swin_base_patch4_window12_384")
    pol = pptq4vit()
    shapes, inv = pswin.op_shapes(cfg), dict(pswin.op_inventory(cfg))
    fc2 = "layers.0.blocks.0.mlp.fc2"
    M = 9216 * 8
    assert kernel_scratch_bytes(shapes[fc2], 8, pol.op_policy(inv[fc2])) \
        == 100 * M * 512 + M * 512 + 4 * 128 * 512
    mm2 = "layers.0.blocks.0.attn.matmul2"
    Z = 4 * 64 * 8
    assert kernel_scratch_bytes(shapes[mm2], 8, pol.op_policy(inv[mm2])) \
        == 2 * Z * 144 * 160 + 100 * Z * 32 * 160 \
        + 4 * 100 * 4 * (64 * 8) * 3 * 1 * 8
    worst = max(kernel_scratch_bytes(i, 32, pol.op_policy(inv[n]))
                for n, i in shapes.items())
    assert worst == kernel_scratch_bytes(shapes[fc2], 32,
                                         pol.op_policy(inv[fc2]))
