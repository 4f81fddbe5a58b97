"""ptq4vit_tpu_torch — the PyTorch / CUDA port of ptq4vit_tpu.

Post-training quantization of vision transformers (PTQ4ViT: parallel
calibration, hessian-guided candidate metric, twin-uniform post-Softmax and
post-GELU quantizers, batched α–β grid search), written for one NVIDIA
H100.  The candidate search scores through hand-written CUDA kernels
(``csrc/search_kernels.cu``); on the CPU the same code runs their plain
PyTorch versions.  The package imports no JAX.
"""

__version__ = "0.1.0"

from .api import quantize  # noqa: E402,F401
