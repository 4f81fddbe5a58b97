"""The port against the reference goldens of the BasePTQ policy (cosine
or hessian metric, one search round, layerwise EasyQuant conv, no twin
quantizers) at W8A8 and W6A6 on the tiny ViT and at W8A8 on the tiny
Swin, and of PTQ4ViT on the tiny Swin at W6A6 and without the
post-softmax twin.

Searched on each golden's own caches with the CPU defaults and held to
``mod::*`` exactly or as f64 ties; the layerwise conv has no tie oracle and
must match exactly, as in tests/test_reference_goldens.py."""
import glob
import os

import pytest

from tests import (test_torch_goldens, test_torch_goldens_ablation,
                   test_torch_goldens_exact, test_torch_goldens_metrics,
                   test_torch_goldens_seq)
from tests import test_reference_goldens as G
from tests.torch_port_helpers import check_golden_cell

CELLS = ["ref_tinyvit_BasePTQ_w8a8_cosine",
         "ref_tinyvit_BasePTQ_w8a8_hessian",
         "ref_tinyvit_BasePTQ_w6a6_cosine",
         "ref_tinyvit_BasePTQ_w6a6_hessian",
         "ref_tinyswin_BasePTQ_w8a8_cosine",
         "ref_tinyswin_PTQ4ViT_w6a6_hessian",
         "ref_tinyswin_PTQ4ViT_w8a8_hessian_nosoftmax"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_search_reproduces_golden(cell):
    check_golden_cell(cell)


def test_every_calibrated_golden_is_held_against_the_port():
    """The 27 calibrated cells of tests/goldens/: 23 parallel cells
    searched on their caches (3 in test_torch_goldens.py, 20 in the
    metric, ablation and policy files) and 4 sequential cells calibrated
    end to end; every hessian cell again with exact scoring through the
    kernels' plain versions."""
    cells = {os.path.basename(p)[:-4]
             for p in glob.glob(os.path.join(G.GOLDEN_DIR, "ref_*.npz"))
             if "ingest" not in p}
    parallel = (set(test_torch_goldens.CELLS) | set(CELLS)
                | set(test_torch_goldens_metrics.CELLS)
                | set(test_torch_goldens_ablation.CELLS))
    seq = set(test_torch_goldens_seq.CELLS)
    assert len(cells) == 27
    assert parallel | seq == cells and not parallel & seq
    assert len(parallel) == 23
    hessian = {c for c in parallel if "hessian" in c}
    assert set(test_torch_goldens_exact.CELLS) == hessian
