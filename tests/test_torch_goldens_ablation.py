"""The port against the reference goldens of the layout and ablation
surface on the tiny ViT: the fully blocked linear grid (n_V = n_H = n_a =
2, hessian and cosine), blocked matmul operands (n_V = n_H = 2 on both
sides, the general blocked engine), and PTQ4ViT without the post-GELU or
the post-softmax twin quantizer.

Searched on each golden's own caches with the CPU defaults and held to
``mod::*`` exactly or as f64 ties (the fully blocked linear through
``_blocked_linear_tie_check``), as tests/test_torch_goldens_metrics.py
does."""
import pytest

from tests.torch_port_helpers import check_golden_cell

CELLS = ["ref_tinyvit_PTQ4ViT_w8a8_hessian_blocked222",
         "ref_tinyvit_PTQ4ViT_w8a8_cosine_blocked222",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_mmblocked",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_nopostgelu",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_nosoftmax"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_search_reproduces_golden(cell):
    check_golden_cell(cell)
