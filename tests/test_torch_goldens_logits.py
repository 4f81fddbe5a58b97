"""The port's raw ViT logits against the reference's: every
``tests/goldens/ref_tinyvit_*.npz`` cell's timm state_dict goes through
the port's ``timm_port`` into a port net, whose logits on the cell's
calibration and evaluation images must equal the reference torch net's
``raw_logits`` / ``raw_logits_eval``; likewise the distilled DeiT
ingestion cell (``head_dist``).  The tolerance is JAX's own, rtol 1e-4 and
atol 1e-4 (tests/test_reference_goldens.py:630, :838-840).  The Swin cells
are held so in tests/test_torch_swin.py."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from ptq4vit_tpu_torch.models import net_from_config
from ptq4vit_tpu_torch.models.vit import ViTConfig
from ptq4vit_tpu_torch.utils.convert import params_from_numpy
from ptq4vit_tpu_torch.utils.timm_port import vit_params_from_state_dict

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CELLS = sorted(os.path.basename(p)[:-4] for p in
               glob.glob(os.path.join(GOLDEN_DIR, "ref_tinyvit_*.npz"))) \
    + ["ref_tinydeit_ingest"]


def port_net_from_golden(z, distilled):
    c = json.loads(str(z["__meta__"]))["cfg"]
    cfg = ViTConfig(name="golden_vit", img_size=c["img_size"],
                    patch_size=c["patch_size"], embed_dim=c["embed_dim"],
                    depth=c["depth"], num_heads=c["num_heads"],
                    num_classes=c["num_classes"], ln_eps=c["ln_eps"],
                    distilled=distilled)
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    return net_from_config(cfg, params_from_numpy(
        vit_params_from_state_dict(sd, cfg)))


def test_every_vit_cell_is_covered():
    assert len(CELLS) == 22


@pytest.mark.parametrize("cell", CELLS)
def test_raw_logits_match_the_reference(cell):
    with np.load(os.path.join(GOLDEN_DIR, f"{cell}.npz")) as z:
        net = port_net_from_golden(z, distilled="tinydeit" in cell)
        if "tinydeit" in cell:
            assert "head_dist" in [n for n, _ in net.op_inventory]
        for x, ref in (("calib_x", "raw_logits"),
                       ("eval_x", "raw_logits_eval")):
            with torch.no_grad():
                got = net.apply(torch.from_numpy(z[x])).numpy()
            assert got.shape == z[ref].shape
            np.testing.assert_allclose(got, z[ref], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{cell} {ref}")
