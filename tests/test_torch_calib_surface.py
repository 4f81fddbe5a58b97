"""The rest of the calibration surface against the JAX package on the tiny
ViT (tests/test_capture.py) with small_cfg (tests/test_calibrator.py):
checkpoint and resume (whole, partial, a changed scope, and across the
two packages both ways), ``wrapped_modules``, the memory knobs
(``device_resident``, ``cache_budget_bytes``, ``search_budget_bytes``),
``profile_dir``, ``mesh``, ``quant_calib``, ``quantize(checkpoint_dir=)``,
``minmax_calib`` and ``apply_bias_correction``.

Port-only runs on the CPU are deterministic, so two port qstates must be
equal bit for bit; port against JAX goes through the f64 tie oracles
(``assert_qstate_matches``), as in tests/test_torch_pipeline.py."""
import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptq4vit_tpu_torch
from ptq4vit_tpu.calib import calibrator as J
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu_torch.calib import calibrator as P
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (SWIN3, TINY, assert_qstate_matches,
                                      bits_meta, golden_view, images,
                                      jax_net, jax_probe_u, jax_swin_net,
                                      np_fields, port_net, shrink)

PROBE_SEED = 3
# the patch-embed conv and every op of block 0 (of the tiny net's 2)
FIRST = ("patch_embed.proj",)


def first_half(inventory):
    return {n: t for n, t in inventory
            if n in FIRST or n.startswith("blocks.0.")}


def port_calib(pnet, x, cfg=None, **kw):
    """A port calibrator on the CPU with the JAX package's probe noise;
    returns (qstate, report)."""
    c = P.HessianQuantCalibrator(
        pnet, cfg if cfg is not None else shrink(pptq4vit()), x,
        batch_size=4, device="cpu", probe_u=jax_probe_u(len(x), 10,
                                                        PROBE_SEED), **kw)
    return c.batching_quant_calib(), c.report


def assert_same(q1, q2):
    """Two qstates of either package: the same ops, kinds and fields, and
    every array bitwise equal."""
    assert set(q1) == set(q2)
    for n in q1:
        assert type(q1[n]).__name__ == type(q2[n]).__name__, n
        a, b = np_fields(q1[n]), np_fields(q2[n])
        assert a.keys() == b.keys(), n
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{n}.{k}")


def assert_matches_jax(pq, jq, jnet, x, jcfg):
    """The port's qstate against JAX's, up to the f64 tie class."""
    caps = jcapture(jnet, x, batch_size=4, need_grad=True,
                    probe_seed=PROBE_SEED)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(jax.tree.map(np.asarray, jnet.params),
                    {n: caps[n] for n in jq}, mods, TINY["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, TINY["patch_size"]),
                          [(n, t) for n, t in jnet.op_inventory if n in jq],
                          kws)


@pytest.fixture(scope="module")
def tiny():
    jnet = jax_net(TINY)
    return jnet, port_net(jnet), images(8, 32)


@pytest.fixture(scope="module")
def port_default(tiny):
    """One uninterrupted port calibration, no checkpoint."""
    _, pnet, x = tiny
    return port_calib(pnet, x)


@pytest.fixture(scope="module")
def jax_dir(tiny, tmp_path_factory):
    """A checkpoint directory written by JAX's calibrator, and its qstate."""
    jnet, _, x = tiny
    d = str(tmp_path_factory.mktemp("jax_ck"))
    jq = J.HessianQuantCalibrator(jnet, shrink(jptq4vit()), x, batch_size=4,
                                  probe_seed=PROBE_SEED, checkpoint_dir=d) \
        .batching_quant_calib(verbose=False)
    return d, jq


def test_signature_takes_jax_arguments_in_order():
    """Every argument of JAX's constructor, in its order and with its
    default, so a JAX call (positional or keyword) works in the port."""
    jp = list(inspect.signature(J.HessianQuantCalibrator).parameters.values())
    pp = list(inspect.signature(P.HessianQuantCalibrator).parameters.values())
    assert [p.name for p in pp[:len(jp)]] == [p.name for p in jp]
    for j, p in zip(jp, pp):
        if p.name != "cache_dtype":
            assert p.default == j.default, p.name
        assert p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD, p.name
    assert P.QuantCalibrator is P.HessianQuantCalibrator
    # the report: JAX's fields in JAX's order, then the port's peak memory
    # and its device allocation count
    jf = [f.name for f in dataclasses.fields(J.CalibReport)]
    pf = [f.name for f in dataclasses.fields(P.CalibReport)]
    assert pf == jf + ["capture_peak_bytes", "device_allocs"]
    assert isinstance(inspect.getattr_static(P.CalibReport, "total_seconds"),
                      property)


def test_group_budget_counts_the_allocators_free_blocks(tiny, monkeypatch):
    """Memory the caching allocator holds with no tensor in it is free to
    the calibration: after an earlier calibration in the same process left
    48 GiB cached, caches that need more than the driver's free memory get
    the budget of a fresh process.  (They did not: the second of four
    ViT-B/384 cells at 128 images planned 49 capture groups instead of 2,
    ROADMAP C7.)  Caches that fit leave the allocator's blocks cached (a
    warm repeat of the headline job pays no release).  A fake driver and
    allocator stand in for the card."""
    _, pnet, x = tiny
    c = P.HessianQuantCalibrator(pnet, shrink(pptq4vit()), x, device="cpu")
    c.device = torch.device("cuda")      # the planner's card branch
    policies = {n: c.cfg.op_policy(t) for n, t in c.wrapped_modules}
    gib = 1 << 30
    card = {"free": 0, "cached": 0, "allocated": gib}

    def empty_cache():
        card["free"] += card["cached"]
        card["cached"] = 0

    monkeypatch.setattr(torch.cuda, "empty_cache", empty_cache)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (card["free"], 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: card["allocated"])
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda d=None: card["allocated"] + card["cached"])

    def budget(free, cached, need):
        card.update(free=free, cached=cached)
        return c._group_budget(c._plan_search(True, policies, need))
    fresh = budget(60 * gib, 0, 0)
    assert fresh > 40 * gib
    assert budget(12 * gib, 48 * gib, 50 * gib) == fresh
    assert card["cached"] == 0
    kept = budget(12 * gib, 48 * gib, gib)
    assert gib <= kept < fresh and card["cached"] == 48 * gib
    assert budget(12 * gib, 0, 50 * gib) == kept


@pytest.mark.parametrize("sequential", [False, True])
def test_report_seconds_add_up(tiny, sequential):
    """setup_seconds is filled in both paradigms, target_seconds only where
    the port computes the probe target on its own (sequential), and
    total_seconds sums the phases as JAX's property does."""
    _, pnet, x = tiny
    _, r = port_calib(pnet, x, sequential=sequential)
    assert r.setup_seconds > 0.0 and r.sync_seconds == 0.0
    assert (r.target_seconds > 0.0) == sequential
    assert r.total_seconds == pytest.approx(
        r.capture_seconds + r.target_seconds + r.setup_seconds
        + sum(r.search_seconds.values()), rel=1e-12)


def test_resume_whole_directory(tiny, port_default, tmp_path):
    """JAX's test_checkpoint_resume: every op loaded, no search."""
    _, pnet, x = tiny
    d = str(tmp_path / "ck")
    q1, r1 = port_calib(pnet, x, checkpoint_dir=d)
    assert len(r1.search_seconds) == len(q1)
    assert sorted(os.listdir(d)) == sorted(f"{n}.npz" for n in q1)
    q2, r2 = port_calib(pnet, x, checkpoint_dir=d)
    assert r2.search_seconds == {} and r2.num_groups == 0
    assert_same(q1, q2)
    assert_same(q1, port_default[0])


@pytest.mark.parametrize("sequential", [False, True])
def test_resume_part_of_the_ops(tiny, port_default, tmp_path, sequential):
    """Calibrate the conv and block 0 into a directory, then every op: the
    second call searches only the rest, and the qstate equals an
    uninterrupted run's in every slot."""
    _, pnet, x = tiny
    d = str(tmp_path / "ck")
    part = first_half(pnet.op_inventory)
    q1, r1 = port_calib(pnet, x, checkpoint_dir=d, wrapped_modules=part,
                        sequential=sequential)
    assert set(q1) == set(r1.search_seconds) == set(part)
    q2, r2 = port_calib(pnet, x, checkpoint_dir=d, sequential=sequential)
    rest = {n for n, _ in pnet.op_inventory} - set(part)
    assert set(r2.search_seconds) == rest
    if sequential:
        q3, _ = port_calib(pnet, x, sequential=True)
        assert_same({n: q2[n] for n in q3}, q3)
    else:
        assert_same(q2, port_default[0])


def test_scope_mismatch_researches_then_resumes(tiny, tmp_path):
    """JAX's test_checkpoint_scope_mismatch: new bits re-search every op,
    and the refreshed directory then resumes cleanly."""
    _, pnet, x = tiny
    d = str(tmp_path / "ck")
    port_calib(pnet, x, checkpoint_dir=d)
    q2, r2 = port_calib(pnet, x, cfg=shrink(pptq4vit()).set_bits(6, 6),
                        checkpoint_dir=d)
    assert len(r2.search_seconds) == len(q2)
    assert q2["blocks.0.attn.qkv"].w_bit == 6
    _, r3 = port_calib(pnet, x, cfg=shrink(pptq4vit()).set_bits(6, 6),
                       checkpoint_dir=d)
    assert r3.search_seconds == {}


def test_jax_directory_resumes_in_the_port(tiny, jax_dir):
    """A directory JAX's calibrator wrote: 0 searches in the port, and
    JAX's intervals."""
    _, pnet, x = tiny
    d, jq = jax_dir
    pq, r = port_calib(pnet, x, checkpoint_dir=d)
    assert r.search_seconds == {}
    assert_same(pq, jq)


def test_port_directory_resumes_in_jax(tiny, jax_dir, tmp_path):
    """A directory the port wrote: 0 searches in JAX, the port's
    intervals, and each file's ``__meta__`` the one JAX writes for the
    same op (kind, scope and fields, in JAX's key order)."""
    jnet, pnet, x = tiny
    d = str(tmp_path / "ck")
    pq, _ = port_calib(pnet, x, checkpoint_dir=d)
    c = J.HessianQuantCalibrator(jnet, shrink(jptq4vit()), x, batch_size=4,
                                 checkpoint_dir=d)
    jq = c.batching_quant_calib(verbose=False)
    assert len(c.report.search_seconds) == 0
    assert_same(jq, pq)
    for n, _ in jnet.op_inventory:
        metas = []
        for root in (d, jax_dir[0]):
            with np.load(os.path.join(root, f"{n}.npz")) as z:
                metas.append(list(json.loads(str(z["__meta__"])).items()))
        assert metas[0] == metas[1], n


def test_wrapped_modules_matches_jax(tiny, tmp_path):
    """``wrapped_modules`` on a subset: JAX's qstate on that subset."""
    jnet, pnet, x = tiny
    part = first_half(jnet.op_inventory)
    jcfg = shrink(jptq4vit())
    jq = J.HessianQuantCalibrator(jnet, jcfg, x, batch_size=4,
                                  probe_seed=PROBE_SEED,
                                  wrapped_modules=part) \
        .batching_quant_calib(verbose=False)
    pq, _ = port_calib(pnet, x, wrapped_modules=part)
    assert list(pq) == list(jq) == list(part)
    assert_matches_jax(pq, jq, jnet, x, jcfg)


@pytest.mark.parametrize("knob", [dict(device_resident=False),
                                  dict(cache_budget_bytes=40_000),
                                  dict(search_budget_bytes=50_000)],
                         ids=["host_caches", "cache_budget", "search_budget"])
def test_memory_knobs_give_the_default_qstate(tiny, port_default, knob):
    """Host-held caches, a cache budget small enough for several capture
    groups, and a small search budget (several candidate chunks) each
    give the default qstate bit for bit."""
    _, pnet, x = tiny
    q, r = port_calib(pnet, x, **knob)
    if "cache_budget_bytes" in knob:
        assert r.num_groups > 1
    assert_same(q, port_default[0])


def test_host_caches_stay_on_the_host(tiny):
    _, pnet, x = tiny
    raw = P.capture(pnet, x, batch_size=4, need_grad=True, to_host=True,
                    device="cpu")
    full = P.capture(pnet, x, batch_size=4, need_grad=True, device="cpu")
    for n, cap in raw.items():
        for k, v in cap.inputs.items():
            assert v.device.type == "cpu"
            torch.testing.assert_close(v, full[n].inputs[k], rtol=0, atol=0)


def test_profile_dir_writes_a_trace(tiny, tmp_path):
    _, pnet, x = tiny
    d = tmp_path / "prof"
    port_calib(pnet, x[:4], wrapped_modules={"head": "qlinear_classifier"},
               profile_dir=str(d))
    traces = list(d.glob("calibration.*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_mesh_raises_naming_a12(tiny):
    """Since A12 the calibrator takes a ("data", "model") DeviceMesh
    (tests/test_torch_parallel_calib.py); anything else is refused."""
    _, pnet, x = tiny
    with pytest.raises(TypeError, match="DeviceMesh"):
        P.HessianQuantCalibrator(pnet, pptq4vit(), x, mesh=object())


def test_quant_calib_is_batching_quant_calib(tiny, port_default):
    _, pnet, x = tiny
    c = P.QuantCalibrator(pnet, shrink(pptq4vit()), x, batch_size=4,
                          device="cpu",
                          probe_u=jax_probe_u(8, 10, PROBE_SEED))
    assert_same(c.quant_calib(), port_default[0])


def test_quantize_checkpoint_dir(tiny, port_default, tmp_path):
    _, pnet, x = tiny
    d = str(tmp_path / "ck")
    kw = dict(config=shrink(pptq4vit()), batch_size=4, device="cpu",
              probe_u=jax_probe_u(8, 10, PROBE_SEED), checkpoint_dir=d,
              return_report=True)
    _, q1, r1 = ptq4vit_tpu_torch.quantize(pnet, x, **kw)
    _, q2, r2 = ptq4vit_tpu_torch.quantize(pnet, x, **kw)
    assert len(r1.search_seconds) == len(q1) and r2.search_seconds == {}
    assert_same(q2, port_default[0])


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_minmax_calib_matches_jax(kind):
    """Every interval of ``minmax_calib`` (rtol 1e-6: the same absmax and
    true division; the captured inputs may differ in the last ulp)."""
    jnet = jax_net(TINY) if kind == "vit" else jax_swin_net(SWIN3)
    x = images(4, 32)
    jq = J.minmax_calib(jnet, shrink(jptq4vit()), x, batch_size=4)
    pq = P.minmax_calib(port_net(jnet), shrink(pptq4vit()), x, batch_size=4)
    assert list(pq) == list(jq)
    for n in jq:
        assert type(pq[n]).__name__ == type(jq[n]).__name__
        a, b = np_fields(pq[n]), np_fields(jq[n])
        assert a.keys() == b.keys(), n
        for k in a:
            assert a[k].shape == b[k].shape, (n, k)
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0,
                                       err_msg=f"{n}.{k}")
        assert pq[n].__dict__.keys() == jq[n].__dict__.keys()


def test_bias_correction_matches_jax(tiny, jax_dir):
    """Corrected biases within atol 1e-6 of JAX's (the mean of a product
    of fake-quant operands, summed in another order), every calibrated
    linear's bias changed, and the original params untouched."""
    jnet, pnet, x = tiny
    _, jq = jax_dir
    ref = jax.tree.map(np.asarray, jnet.params)
    jp = J.apply_bias_correction(jnet, jq, x)
    pp = P.apply_bias_correction(pnet, qstate_from_numpy(jq), x)
    for n, t in jnet.op_inventory:
        if not t.startswith("qlinear"):
            continue
        jb = np.asarray(P.params_for_op(jp, n)[1])
        pb = P.params_for_op(pp, n)[1].numpy()
        b0 = P.params_for_op(ref, n)[1]
        np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6, err_msg=n)
        assert not np.array_equal(pb, b0), n
        np.testing.assert_array_equal(
            P.params_for_op(pnet.params, n)[1].numpy(), b0, err_msg=n)
    with torch.no_grad():
        out = pnet.forward(pp, torch.from_numpy(x[:2]), pnet.cfg,
                           qstate=qstate_from_numpy(jq))
    assert torch.isfinite(out).all()
    assert jnp.all(jnp.isfinite(jnet.forward(jp, jnp.asarray(x[:2]),
                                             jnet.cfg, qstate=jq)))
