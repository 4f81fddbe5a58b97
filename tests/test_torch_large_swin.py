"""A calibration at Swin-L/384's width against the JAX package.

Swin-L/384's width and heads (embed 192, heads 6 / 12 / 24 / 48 of 32,
stage 4 at 1536 wide with a 6144-wide MLP) at depths (2, 1, 1, 1) on a
32-pixel image in patches of 4 (res 8 in windows of 4, stage 1's second
block shifted, then res 4, 2 and 1, one window each), on 2 images:
tests/test_torch_large.py's check against the JAX calibrator.
"""
from tests.test_torch_large import check_quantize_matches_jax
from tests.torch_port_helpers import jax_swin_net

SWIN_L_WIDTH = dict(img_size=32, patch_size=4, embed_dim=192,
                    depths=(2, 1, 1, 1), num_heads=(6, 12, 24, 48),
                    window_size=4, num_classes=10)


def test_swin_l_width_quantize_matches_jax():
    check_quantize_matches_jax(jax_swin_net(SWIN_L_WIDTH), SWIN_L_WIDTH)
