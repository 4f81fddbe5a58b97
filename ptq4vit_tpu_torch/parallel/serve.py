"""Batched int8 serving on one device or data-parallel over a mesh.

The counterpart of ``ptq4vit_tpu/parallel/serve.py`` ``ServingEngine``:
packed int8 weights and the fused kernels (``int8="fused"``: B6 and B7 on
every ViT block; B10, B9, B11 and B6 on every Swin block).  Model-agnostic:
the net's own forward picks its fused blocks.  In bf16 the residual
stream, biases and LayerNorm weights are bf16; the kernels accumulate
exactly in int32, rescale in fp32, and B9 adds the rel-pos bias and the
shifted mask in fp32.  ``relaxed=True`` serves in ``int8="fused_relaxed"``
(JAX's opt-in mode: the kernels' epilogues in bf16, levels within a step
of the exact ones).  Over a mesh (``parallel/mesh.make_mesh``) every rank
holds the whole params and packed weights, runs the fused forward on its
block of the batch and gathers the logits over "data", as JAX's
``shard_map`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.registry import resolve_device
from ..ops.pack import pack_weights
from ..quant.fakequant import exact_div
from ..utils.convert import params_from_numpy, qstate_to
from ..utils.tracing import span
from .mesh import all_gather, axis_size, check_mesh, shard_batch


class ServingEngine:
    """Quantized inference with packed int8 weights and the fused kernels.

    net:      models.registry.Net
    qstate:   calibrated quantization state
    mesh:     optional ("data", "model") DeviceMesh (``make_mesh``): the
              batch splits over "data" and the logits are gathered back
    compute_dtype: dtype of the float segments (bfloat16 by default)
    relaxed:  the relaxed bf16 epilogues (``int8="fused_relaxed"``)
    raw_uint8: take (B, 3, H, W) uint8 images and normalize them on the
              device with ``net.data_config`` (4x fewer bytes to the card)
    device:   the card by default; ``device="cpu"`` runs the kernels'
              plain versions
    """

    def __init__(self, net, qstate: Dict[str, Any], mesh=None,
                 compute_dtype=torch.bfloat16, relaxed: bool = False,
                 raw_uint8: bool = False, device=None):
        self.mesh = check_mesh(mesh)
        self.mode = "fused_relaxed" if relaxed else "fused"
        self.net = net
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self._params = params_from_numpy(net.params, self.device)
        self._qstate = qstate_to(qstate, self.device)
        self._packed = pack_weights(self._params, self._qstate)
        if net.serving_terms is not None:
            # fixed per-block operands (Swin's B9 terms), made once here
            # and not in every request
            self._packed.update(net.serving_terms(self._params, net.cfg,
                                                  compute_dtype))
        self._norm = None
        if raw_uint8:
            dc = net.data_config
            self._norm = tuple(
                torch.tensor(np.asarray(v, np.float32).reshape(1, 3, 1, 1),
                             device=self.device) for v in (dc.mean, dc.std))

    def __call__(self, x) -> torch.Tensor:
        """x: (B, 3, H, W) float (or uint8 with ``raw_uint8``), numpy or a
        tensor -> (B, num_classes) logits in ``compute_dtype``.  With a
        mesh, B must divide by the data axis (pad upstream)."""
        with span("ptq.serve.request"):
            with span("ptq.serve.h2d"):
                x = self._to_device(x)
            with span("ptq.serve.forward"), torch.no_grad():
                out = self.net.forward(self._params, x, self.net.cfg,
                                       qstate=self._qstate, int8=self.mode,
                                       packed=self._packed,
                                       compute_dtype=self.compute_dtype)
            if self.mesh is None:
                return out
            with span("ptq.serve.gather"):
                return all_gather(out, self.mesh, "data")

    def _to_device(self, x) -> torch.Tensor:
        """The request's images on this rank's device: its block of the
        batch over a mesh, normalized there with ``raw_uint8``."""
        x = torch.as_tensor(x)
        if self.mesh is not None:
            if x.shape[0] % axis_size(self.mesh, "data"):
                raise ValueError(
                    f"a batch of {x.shape[0]} does not divide over data="
                    f"{axis_size(self.mesh, 'data')}; pad it upstream")
            x = shard_batch(x, self.mesh)
        x = x.to(self.device)
        if self._norm is not None:
            mean, std = self._norm
            x = exact_div(exact_div(x.float(), 255.0) - mean, std)
        return x
