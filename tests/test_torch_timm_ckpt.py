"""The checkpoint half of the port's ``utils/timm_port.py`` against the JAX
package's: npz round trips, npz files crossing between the packages both
ways (the same flat keys and arrays), .pth conversion and discovery under
``$PTQ4VIT_TPU_CKPT_DIR``, and ``quantize(params=None)`` taking the
checkpoint, as JAX's does.  State dicts are the hand-written timm key
tables of tests/test_timm_port.py, filled from a seeded generator."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptq4vit_tpu_torch
from ptq4vit_tpu import api as japi
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.models import registry as jreg
from ptq4vit_tpu.utils import timm_port as J
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.models import registry as preg
from ptq4vit_tpu_torch.utils import timm_port as P
from tests.test_timm_port import SWIN_CFG, VIT_CFG, _swin_sd, _vit_sd
from tests.torch_port_helpers import images, shrink

# a MODEL_ZOO row small enough for a CPU calibration, added to both
# packages' registries for the tests that go through a model name
TINY_NAME = "vit_test_patch8_32"
TINY_ROW = dict(kind="vit", mean=(0.5,) * 3, std=(0.5,) * 3, img=32,
                patch=8, dim=24, depth=2, heads=3, crop_pct=1.0)


@pytest.fixture
def tiny_zoo(monkeypatch, tmp_path):
    """The tiny row in both registries, and ``$PTQ4VIT_TPU_CKPT_DIR`` at a
    fresh directory."""
    monkeypatch.setitem(jreg.MODEL_ZOO, TINY_NAME, TINY_ROW)
    monkeypatch.setitem(preg.MODEL_ZOO, TINY_NAME, TINY_ROW)
    d = tmp_path / "ckpts"
    d.mkdir()
    monkeypatch.setenv(P.CKPT_ENV, str(d))
    return d


def assert_flat_equal(a, b):
    """The same flat keys (jax.tree.map sorts dict keys, so in any order)
    and bitwise equal arrays of the same dtype."""
    fa, fb = P.flatten_params(a), J.flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_ckpt_env_is_jax_s():
    assert P.CKPT_ENV == J.CKPT_ENV == "PTQ4VIT_TPU_CKPT_DIR"


def test_npz_round_trip(rng, tmp_path):
    """A 12-block ViT, so block 10 must not sort before block 2."""
    sd = _vit_sd(VIT_CFG, rng)
    params = P.vit_params_from_state_dict(dict(sd), VIT_CFG)
    path = str(tmp_path / "m.npz")
    P.save_params_npz(path, params)
    back = P.load_params_npz(path)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 12
    fa, fb = P.flatten_params(params), P.flatten_params(back)
    assert list(fa) == list(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    np.testing.assert_array_equal(back["blocks"][10]["mlp"]["fc1"]["weight"],
                                  sd["blocks.10.mlp.fc1.weight"])


def test_flatten_takes_tensors(rng):
    params = P.vit_params_from_state_dict(dict(_vit_sd(VIT_CFG, rng)),
                                          VIT_CFG)
    on_torch = jax.tree.map(torch.from_numpy, params)
    assert_flat_equal(on_torch, params)


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_npz_crosses_between_the_packages(rng, tmp_path, kind):
    """An npz JAX's save_params_npz wrote loads in the port with the same
    flat keys and arrays, and the port's loads in JAX."""
    cfg, make = (VIT_CFG, _vit_sd) if kind == "vit" else (SWIN_CFG, _swin_sd)
    fn = (J.vit_params_from_state_dict if kind == "vit"
          else J.swin_params_from_state_dict)
    sd = make(cfg, rng)
    jparams = fn(dict(sd), cfg)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    J.save_params_npz(jpath, jparams)
    assert_flat_equal(P.load_params_npz(jpath), jparams)
    pfn = (P.vit_params_from_state_dict if kind == "vit"
           else P.swin_params_from_state_dict)
    pparams = pfn(dict(sd), cfg)
    assert_flat_equal(pparams, jparams)
    P.save_params_npz(ppath, pparams)
    assert_flat_equal(pparams, J.load_params_npz(ppath))


def test_pth_converts_and_is_found(rng, tiny_zoo):
    """A .pth written with torch.save converts to the npz JAX's converter
    writes, and load_timm_checkpoint_if_any finds it."""
    cfg = jreg.model_config(TINY_NAME)
    sd = _vit_sd(cfg, rng)
    pth = tiny_zoo / f"{TINY_NAME}.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(pth))
    assert P.load_timm_checkpoint_if_any("no_such_model") is None
    params = P.load_timm_checkpoint_if_any(TINY_NAME)      # converts first
    npz = tiny_zoo / f"{TINY_NAME}.npz"
    assert npz.exists()
    np.testing.assert_array_equal(params["blocks"][1]["attn"]["qkv"]["weight"],
                                  sd["blocks.1.attn.qkv.weight"])
    jout = J.convert_torch_checkpoint(TINY_NAME, str(pth),
                                      str(tiny_zoo / "j.npz"))
    with np.load(str(npz)) as a, np.load(jout) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_quantize_params_none_uses_the_checkpoint(rng, tiny_zoo):
    """With a checkpoint in ``$PTQ4VIT_TPU_CKPT_DIR``, ``quantize(params=
    None)`` builds the checkpoint's net in both packages: the port's params
    are the checkpoint's and its raw logits equal those of JAX's net
    within rtol 1e-4, atol 1e-4 (JAX's own tolerance for raw logits of
    converted timm weights, tests/test_reference_goldens.py:630; these
    unit-variance weights give logits up to ~28).
    Without one, the port initializes at random from ``seed``."""
    cfg = jreg.model_config(TINY_NAME)
    sd = _vit_sd(cfg, rng)
    ckpt = J.vit_params_from_state_dict(dict(sd), cfg)
    x = images(4, 32)
    pnet, _ = ptq4vit_tpu_torch.quantize(TINY_NAME, x,
                                         config=shrink(pptq4vit()),
                                         batch_size=4, device="cpu")
    assert not np.array_equal(pnet.params["cls_token"].numpy(),
                              sd["cls_token"])                 # random init
    P.save_params_npz(str(tiny_zoo / f"{TINY_NAME}.npz"), ckpt)
    pnet, pq = ptq4vit_tpu_torch.quantize(TINY_NAME, x,
                                          config=shrink(pptq4vit()),
                                          batch_size=4, device="cpu")
    jnet, _ = japi.quantize(TINY_NAME, x, config=shrink(jptq4vit()),
                            batch_size=4)
    assert len(pq) == len(pnet.op_inventory)
    assert_flat_equal(pnet.params, jax.tree.map(np.asarray, ckpt))
    assert_flat_equal(pnet.params, jax.tree.map(np.asarray, jnet.params))
    with torch.no_grad():
        got = pnet.apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.apply(
        jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    assert os.environ[P.CKPT_ENV] == str(tiny_zoo)
