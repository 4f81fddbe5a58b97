"""The sequential golden cells calibrated end to end by the port:
``quantize(..., sequential=True)`` on the golden's own net and images,
with the probe noise the JAX package draws.  Each op is captured with the
ops before it (in the reference's module order: ``proj`` before the
attention matmuls) in fake-quant.

Each op's intervals are held to the reference's ``mod::*`` as
``test_reference_golden`` holds the JAX package's (``seq=True``: the
port's activation picks are scored on the reference's f64 curve).  Once an
earlier pick has broken an f64 tie the other way (a branch point, itself
proven a tie), the port captures different data downstream -- several
percent of max |x| a block later -- and its optimum moves with them; a
downstream op that misses the reference's curve must then be f64
tie-optimal on the port's own captures of that step.  Before any branch
point a miss fails."""
import jax
import numpy as np
import pytest
import torch

from ptq4vit_tpu_torch import quantize
from ptq4vit_tpu_torch.calib.capture import capture, probe_target
from ptq4vit_tpu_torch.models.net_wrap import reference_wrap_order
from tests import test_reference_goldens as G
from tests.torch_port_helpers import (assert_qstate_matches, golden_view,
                                      jax_probe_u, load_golden, np_fields,
                                      port_cfg, port_net, split_tie_check)

CELLS = ["ref_tinyvit_PTQ4ViT_w8a8_hessian_sequential",
         "ref_tinyvit_PTQ4ViT_w6a6_hessian_sequential",
         "ref_tinyvit_BasePTQ_w8a8_cosine_sequential",
         "ref_tinyswin_PTQ4ViT_w8a8_hessian_sequential"]


def own_tie_check(z, meta, name, mtype, qp, kws):
    """Every slot of the port's pick is f64 tie-optimal on ``z``, the
    port's own captures of this step (its picks standing as ``mod::*``)."""
    f = np_fields(qp)
    if "qmatmul" in mtype:
        kw = kws["matmul"]
        if "split" in f:
            split = float(f["split"])
            split_tie_check(z, meta, name, mtype, kw, split, split)
            G._sos_b_tie_check(z, meta, name, mtype,
                               list(range(f["B_interval"].size)),
                               f["B_interval"].reshape(-1), kw, split)
            return
        ra = f["A_interval"].reshape(-1)
        for which in ("A", "B"):
            G._matmul_tie_check(z, meta, name, mtype, which,
                                list(range(ra.size)),
                                f[f"{which}_interval"].reshape(-1), kw, ra)
        return
    assert mtype != "qconv", "the conv comes first: no branch before it"
    rw = f["w_interval"].reshape(-1)
    for which in ("w", "a"):
        flat = f[f"{which}_interval"].reshape(-1)
        G._linear_tie_check(z, meta, name, mtype, which,
                            list(range(flat.size)), flat, kws["linear"], rw,
                            False, qp.postgelu)


@pytest.mark.parametrize("cell", CELLS)
def test_port_sequential_calibration_reproduces_golden(cell):
    z, meta, jnet, mods = load_golden(cell)
    pnet = port_net(jnet)
    x = z["calib_x"]
    cfg = port_cfg(meta)
    u = jax_probe_u(len(x), jnet.cfg.num_classes, meta["probe_seed"])
    _, pq = quantize(pnet, x, config=cfg, bits=tuple(meta["bit_setting"]),
                     batch_size=meta["batch_size"], device="cpu",
                     sequential=True, probe_sigma=meta["probe_sigma"],
                     probe_u=u)
    order = reference_wrap_order(pnet.op_inventory)
    assert list(pq) == [n for n, _ in order]
    kws = meta["ref_kwargs"]
    need_grad = any(cfg.op_policy(t).metric == "hessian" for _, t in order)
    with torch.no_grad():
        target = probe_target(pnet.apply(torch.from_numpy(x)),
                              torch.from_numpy(np.array(u)),
                              meta["probe_sigma"])
    branched = False
    for i, (name, mtype) in enumerate(order):
        try:
            assert_qstate_matches({name: pq[name]}, mods, z, meta,
                                  [(name, mtype)], kws, seq=True)
        except AssertionError:
            if not branched:
                raise
            prefix = {n: pq[n] for n, _ in order[:i]}
            caps = capture(pnet, x, batch_size=meta["batch_size"],
                           need_grad=need_grad, ops=[name], qstate=prefix,
                           target_probs=target)
            own = golden_view(jax.tree.map(np.asarray, jnet.params), caps,
                              {name: np_fields(pq[name])},
                              jnet.cfg.patch_size)
            own_tie_check(own, meta, name, mtype, pq[name], kws)
        branched = branched or any(
            not np.allclose(v.reshape(-1),
                            np.asarray(mods[name][k]).reshape(-1), rtol=1e-5)
            for k, v in np_fields(pq[name]).items() if k in mods[name])


def test_reference_wrap_order_puts_proj_before_the_matmuls():
    """The port's copy of the module-walk order equals the JAX package's
    on ViT and Swin inventories."""
    from ptq4vit_tpu.models.net_wrap import reference_wrap_order as jorder
    for cell in ("ref_tinyvit_PTQ4ViT_w8a8_hessian_sequential",
                 "ref_tinyswin_PTQ4ViT_w8a8_hessian_sequential"):
        _, _, jnet, _ = load_golden(cell)
        inv = list(jnet.op_inventory)
        assert reference_wrap_order(inv) == jorder(inv)
    order = [n for n, _ in reference_wrap_order(inv)]
    attn = [n for n in order if n.startswith("layers.0.blocks.0.attn.")]
    assert [n.rsplit(".", 1)[1] for n in attn] == ["qkv", "proj", "matmul1",
                                                    "matmul2"]
