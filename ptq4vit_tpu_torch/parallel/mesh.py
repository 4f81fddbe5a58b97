"""Classification evaluation on one device.

The counterpart of ``ptq4vit_tpu/parallel/mesh.py`` ``Evaluator`` and
``test_classification`` without a mesh, for ViT / DeiT and Swin alike
(``int8="fused"`` runs each net's fused blocks): the ("data", "model")
mesh and tensor parallelism wait for multi-GPU (ROADMAP A12) and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..quant.fakequant import exact_div
from ..utils.convert import params_from_numpy, qstate_to


class Evaluator:
    """(Optionally quantized) classification accuracy: raw FP32 forward
    without a qstate, fake-quant with one, int8 with ``int8=True`` or
    ``"fused"``.  ``data_config`` normalizes uint8 images on the device."""

    def __init__(self, net, qstate: Optional[Dict[str, Any]] = None,
                 mesh=None, tensor_parallel: bool = False, int8=False,
                 data_config=None, device=None):
        if mesh is not None or tensor_parallel:
            raise NotImplementedError("a device mesh needs multi-GPU "
                                      "evaluation (ROADMAP A12)")
        self.net = net
        self.int8 = int8
        self.device = torch.device(device) if device is not None else \
            net.params["head"]["weight"].device
        self._params = params_from_numpy(net.params, self.device)
        self._qstate = qstate_to(qstate, self.device) if qstate else qstate
        self._norm = None
        if data_config is not None:
            self._norm = tuple(
                torch.tensor(np.asarray(v, np.float32).reshape(1, 3, 1, 1),
                             device=self.device)
                for v in (data_config.mean, data_config.std))

    def logits(self, x) -> torch.Tensor:
        """The forward's logits of a batch (uint8 images normalized on the
        device first when ``data_config`` was given)."""
        x = torch.as_tensor(x).to(self.device)
        if self._norm is not None:
            mean, std = self._norm
            x = exact_div(exact_div(x.float(), 255.0) - mean, std)
        with torch.no_grad():
            return self.net.forward(self._params, x, self.net.cfg,
                                    qstate=self._qstate, int8=self.int8)

    def _n_correct_dev(self, x, y) -> torch.Tensor:
        """The count of correct predictions as a device scalar (no sync)."""
        y = torch.as_tensor(y).to(self.device)
        return torch.sum(torch.argmax(self.logits(x), -1) == y)

    def n_correct(self, x, y) -> int:
        return int(self._n_correct_dev(x, y))

    def evaluate(self, loader, max_iteration: Optional[int] = None,
                 verbose: bool = False) -> float:
        """Accuracy over ``loader`` ((x, y) batches).  The per-batch counts
        stay on the device and are read once at the end, so the host never
        waits for a batch."""
        counts, tot = [], 0
        for i, (x, y) in enumerate(loader):
            counts.append(self._n_correct_dev(x, y))
            tot += len(y)
            if verbose:
                print(f"\r[eval] batch {i + 1}, {tot} images", end="",
                      flush=True)
            if max_iteration is not None and i + 1 >= max_iteration:
                break
        pos = int(torch.stack(counts).sum()) if counts else 0
        if verbose:
            print(f"\r[eval] {pos}/{tot} acc={pos / max(tot, 1):.4f}")
        return pos / max(tot, 1)


def test_classification(net, loader, qstate=None, mesh=None,
                        max_iteration=None, description=None) -> float:
    """The reference's helper (example/test_vit.py:26-45)."""
    acc = Evaluator(net, qstate=qstate, mesh=mesh).evaluate(
        loader, max_iteration=max_iteration, verbose=description is not None)
    print(acc)
    return acc


test_classification.__test__ = False      # not a pytest test
