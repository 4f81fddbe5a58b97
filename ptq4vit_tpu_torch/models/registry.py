"""Model registry: the timm model names the reference grid covers, with
architecture and input-preprocessing metadata.

The counterpart of ``ptq4vit_tpu/models/registry.py``; ``MODEL_ZOO`` is the
same data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..utils.convert import params_from_numpy
from . import swin as swin_mod
from . import swinv2 as swinv2_mod
from . import vit as vit_mod

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    input_size: int
    crop_pct: float
    mean: tuple
    std: tuple
    interpolation: str = "bicubic"


_VIT = dict(kind="vit", mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD)
_DEIT = dict(kind="vit", mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)
_SWIN = dict(kind="swin", mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)
_SWINV2 = dict(_SWIN, kind="swinv2")

MODEL_ZOO: Dict[str, Dict[str, Any]] = {
    "vit_tiny_patch16_224": dict(**_VIT, img=224, patch=16, dim=192, depth=12,
                                 heads=3, crop_pct=0.9),
    "vit_small_patch32_224": dict(**_VIT, img=224, patch=32, dim=384, depth=12,
                                  heads=6, crop_pct=0.9),
    "vit_small_patch16_224": dict(**_VIT, img=224, patch=16, dim=384, depth=12,
                                  heads=6, crop_pct=0.9),
    "vit_base_patch16_224": dict(**_VIT, img=224, patch=16, dim=768, depth=12,
                                 heads=12, crop_pct=0.9),
    "vit_base_patch16_384": dict(**_VIT, img=384, patch=16, dim=768, depth=12,
                                 heads=12, crop_pct=1.0),
    "vit_large_patch16_224": dict(**_VIT, img=224, patch=16, dim=1024, depth=24,
                                  heads=16, crop_pct=0.9),
    "vit_large_patch16_384": dict(**_VIT, img=384, patch=16, dim=1024, depth=24,
                                  heads=16, crop_pct=1.0),
    "deit_tiny_patch16_224": dict(**_DEIT, img=224, patch=16, dim=192, depth=12,
                                  heads=3, crop_pct=0.9),
    "deit_small_patch16_224": dict(**_DEIT, img=224, patch=16, dim=384,
                                   depth=12, heads=6, crop_pct=0.9),
    "deit_base_patch16_224": dict(**_DEIT, img=224, patch=16, dim=768, depth=12,
                                  heads=12, crop_pct=0.9),
    "deit_base_patch16_384": dict(**_DEIT, img=384, patch=16, dim=768, depth=12,
                                  heads=12, crop_pct=1.0),
    "deit_tiny_distilled_patch16_224": dict(**_DEIT, img=224, patch=16,
                                            dim=192, depth=12, heads=3,
                                            crop_pct=0.9, distilled=True),
    "deit_small_distilled_patch16_224": dict(**_DEIT, img=224, patch=16,
                                             dim=384, depth=12, heads=6,
                                             crop_pct=0.9, distilled=True),
    "deit_base_distilled_patch16_224": dict(**_DEIT, img=224, patch=16,
                                            dim=768, depth=12, heads=12,
                                            crop_pct=0.9, distilled=True),
    "deit_base_distilled_patch16_384": dict(**_DEIT, img=384, patch=16,
                                            dim=768, depth=12, heads=12,
                                            crop_pct=1.0, distilled=True),
    "swin_tiny_patch4_window7_224": dict(**_SWIN, img=224, patch=4, dim=96,
                                         depths=(2, 2, 6, 2),
                                         heads=(3, 6, 12, 24), window=7,
                                         crop_pct=0.9),
    "swin_small_patch4_window7_224": dict(**_SWIN, img=224, patch=4, dim=96,
                                          depths=(2, 2, 18, 2),
                                          heads=(3, 6, 12, 24), window=7,
                                          crop_pct=0.9),
    "swin_base_patch4_window7_224": dict(**_SWIN, img=224, patch=4, dim=128,
                                         depths=(2, 2, 18, 2),
                                         heads=(4, 8, 16, 32), window=7,
                                         crop_pct=0.9),
    "swin_base_patch4_window12_384": dict(**_SWIN, img=384, patch=4, dim=128,
                                          depths=(2, 2, 18, 2),
                                          heads=(4, 8, 16, 32), window=12,
                                          crop_pct=1.0),
    "swin_large_patch4_window7_224": dict(**_SWIN, img=224, patch=4, dim=192,
                                          depths=(2, 2, 18, 2),
                                          heads=(6, 12, 24, 48), window=7,
                                          crop_pct=0.9),
    "swin_large_patch4_window12_384": dict(**_SWIN, img=384, patch=4,
                                           dim=192, depths=(2, 2, 18, 2),
                                           heads=(6, 12, 24, 48), window=12,
                                           crop_pct=1.0),
    # Swin V2-B fine-tuned at 384 px from 192 px (window 12 -> 24): the
    # CPB coordinates keep the pretraining windows
    "swinv2_base_window12to24_192to384": dict(
        **_SWINV2, img=384, patch=4, dim=128, depths=(2, 2, 18, 2),
        heads=(4, 8, 16, 32), window=24, pretrained_windows=(12, 12, 12, 6),
        crop_pct=1.0),
}


@dataclasses.dataclass
class Net:
    """Functional model bundle: config, params, forward and op metadata."""
    name: str
    cfg: Any
    params: Dict[str, Any]
    forward: Callable              # forward(params, x, cfg, qstate, ...)
    op_inventory: list             # ordered (op name, module_type)
    op_shapes: Dict[str, Any]
    data_config: DataConfig
    # serving_terms(params, cfg, compute_dtype) -> ``packed`` entries a
    # serving engine builds once (Swin: B9's window terms), or None
    serving_terms: Optional[Callable] = None

    def apply(self, x, qstate=None, eps=None, capture=False, int8=False,
              packed=None, compute_dtype=None):
        return self.forward(self.params, x, self.cfg, qstate=qstate, eps=eps,
                            capture=capture, int8=int8, packed=packed,
                            compute_dtype=compute_dtype)


def model_config(name: str):
    """The ViTConfig, SwinConfig or SwinV2Config of a MODEL_ZOO row."""
    z = MODEL_ZOO[name]
    if z["kind"] == "vit":
        return vit_mod.ViTConfig(name=name, img_size=z["img"],
                                 patch_size=z["patch"], embed_dim=z["dim"],
                                 depth=z["depth"], num_heads=z["heads"],
                                 distilled=z.get("distilled", False))
    kw = dict(name=name, img_size=z["img"], patch_size=z["patch"],
              embed_dim=z["dim"], depths=z["depths"], num_heads=z["heads"],
              window_size=z["window"])
    if z["kind"] == "swinv2":
        return swinv2_mod.SwinV2Config(
            pretrained_window_sizes=z["pretrained_windows"], **kw)
    return swin_mod.SwinConfig(**kw)


def _model_module(cfg):
    if isinstance(cfg, swinv2_mod.SwinV2Config):
        return swinv2_mod
    return swin_mod if isinstance(cfg, swin_mod.SwinConfig) else vit_mod


def net_from_config(cfg, params: Dict[str, Any],
                    data_config: Optional[DataConfig] = None) -> Net:
    """Bundle a ViT, Swin or Swin V2 config and its params (also for
    custom-size nets); the forward and op metadata follow the config's
    type."""
    if data_config is None:
        data_config = DataConfig(cfg.img_size, 1.0, IMAGENET_INCEPTION_MEAN,
                                 IMAGENET_INCEPTION_STD)
    mod = _model_module(cfg)
    return Net(name=cfg.name, cfg=cfg, params=params, forward=mod.forward,
               op_inventory=mod.op_inventory(cfg),
               op_shapes=mod.op_shapes(cfg), data_config=data_config,
               serving_terms=getattr(mod, "serving_terms", None))


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; a CUDA device with no card
    raises (the port's entry points run on the card unless the caller asks
    for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run on the CPU")
    return device


def get_net(name: str, params: Optional[Dict[str, Any]] = None,
            seed: int = 0, device=None) -> Net:
    """Build a model bundle on ``device`` (default: the card).
    ``params=None`` random-initializes from a numpy generator seeded with
    ``seed``; given params (numpy or torch, timm key layout) are moved
    there."""
    if name not in MODEL_ZOO:
        raise NotImplementedError(f"unknown model {name}")
    device = resolve_device(device)
    z = MODEL_ZOO[name]
    cfg = model_config(name)
    if params is None:
        params = _model_module(cfg).init_params(
            cfg, np.random.default_rng(seed), device=device)
    else:
        params = params_from_numpy(params, device)
    return net_from_config(cfg, params, DataConfig(
        input_size=z["img"], crop_pct=z["crop_pct"], mean=z["mean"],
        std=z["std"]))
