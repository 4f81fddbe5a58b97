"""Every hessian golden cell searched with exact scoring through the
kernels (``use_kernels=True, int8_score=False``): on CPU tensors the
linear searches run B4w's and B4a's plain versions wherever the JAX
package scores in ``linear_w_hessian_sims`` / ``linear_a_hessian_sims``
(n_H = 1 / n_a = 1), the rest is plain torch as with the CPU defaults.
Held to the reference's ``mod::*`` exactly or as f64 ties."""
import pytest

from tests.torch_port_helpers import check_golden_cell

CELLS = ["ref_tinyvit_PTQ4ViT_w8a8_hessian",
         "ref_tinyvit_PTQ4ViT_w6a6_hessian",
         "ref_tinyvit_BasePTQ_w8a8_hessian",
         "ref_tinyvit_BasePTQ_w6a6_hessian",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_blocked222",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_mmblocked",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_nopostgelu",
         "ref_tinyvit_PTQ4ViT_w8a8_hessian_nosoftmax",
         "ref_tinyswin_PTQ4ViT_w8a8_hessian",
         "ref_tinyswin_PTQ4ViT_w6a6_hessian",
         "ref_tinyswin_PTQ4ViT_w8a8_hessian_nosoftmax",
         "ref_tinyswin3_PTQ4ViT_w8a8_hessian"]


@pytest.mark.parametrize("cell", CELLS)
def test_exact_kernel_search_reproduces_golden(cell):
    check_golden_cell(cell, int8_score=False, use_kernels=True)
