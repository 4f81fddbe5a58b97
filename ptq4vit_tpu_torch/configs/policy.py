"""Quantization policy configs: the declarative equivalent of the
reference's config modules (configs/BasePTQ.py, configs/PTQ4ViT.py in
hahnyuan/PTQ4ViT).

A framework-neutral copy of ``ptq4vit_tpu/configs/policy.py``: importing
the JAX package would load JAX, so the port carries its own copy and the
tests hold the two equal field by field.

The reference expresses policy as module-level dicts mutated in place plus a
``get_module`` factory building nn.Modules (configs/PTQ4ViT.py:51-80).  Here
a :class:`QuantConfig` holds the same knobs as data and
:meth:`QuantConfig.op_policy` resolves a per-op :class:`OpPolicy` from the
9 module-type names (net_wrap.py:42) with the same special cases:

  * qconv         -> a_bit=32 (activation quant off, BasePTQ.py:50 /
                     PTQ4ViT.py:54); channelwise weights under PTQ4ViT,
                     layerwise under BasePTQ.
  * qlinear_qkv   -> n_V *= 3 (q,k,v row blocks, BasePTQ.py:54).
  * qlinear_MLP_2 -> twin-uniform post-GELU quantizer under PTQ4ViT unless
                     no_postgelu (PTQ4ViT.py:61-65).
  * qlinear_classifier -> n_V forced to 1 (PTQ4ViT.py:66-68).
  * qmatmul_scorev -> split-of-softmax quantizer under PTQ4ViT unless
                     no_softmax (PTQ4ViT.py:73-79).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

CONV_FC_NAMES = ("qconv", "qlinear_qkv", "qlinear_proj", "qlinear_MLP_1",
                 "qlinear_MLP_2", "qlinear_classifier", "qlinear_reduction")
MATMUL_NAMES = ("qmatmul_qk", "qmatmul_scorev")


@dataclasses.dataclass(frozen=True)
class OpPolicy:
    """Resolved per-op search policy (static — hashable for jit)."""
    quantizer: str          # linear | postgelu_linear | matmul | sos_matmul |
                            # conv_channelwise | conv_layerwise
    metric: str
    eq_alpha: float
    eq_beta: float
    eq_n: int
    search_round: int
    w_bit: int = 8
    a_bit: int = 8          # also used as A_bit for matmuls
    b_bit: int = 8          # B_bit for matmuls
    n_V: int = 1
    n_H: int = 1
    n_a: int = 1
    n_G_A: int = 1          # overridden to num-heads at calibration time
    n_V_A: int = 1
    n_H_A: int = 1
    n_G_B: int = 1
    n_V_B: int = 1
    n_H_B: int = 1
    init_layerwise: bool = False
    bias_correction: bool = False
    w_quantile: float = 0.9999   # conv_quantile variant (conv.py:91-124)
    a_quantile: float = 0.9999


@dataclasses.dataclass
class QuantConfig:
    """Mutable config mirroring the reference's module-level knobs."""
    name: str
    bit: int = 8
    w_bit: Dict[str, int] = None
    a_bit: Dict[str, int] = None
    A_bit: Dict[str, int] = None
    B_bit: Dict[str, int] = None
    ptqsl_conv2d_kwargs: Dict = None
    ptqsl_linear_kwargs: Dict = None
    ptqsl_matmul_kwargs: Dict = None
    no_softmax: bool = False
    no_postgelu: bool = False
    conv_channelwise: bool = True   # PTQ4ViT conv vs BasePTQ EasyQuant conv
    conv_quantizer: Optional[str] = None  # override: "conv_quantile" etc.

    def __post_init__(self):
        if self.w_bit is None:
            self.w_bit = {n: self.bit for n in CONV_FC_NAMES}
        if self.a_bit is None:
            self.a_bit = {n: self.bit for n in CONV_FC_NAMES}
        if self.A_bit is None:
            self.A_bit = {n: self.bit for n in MATMUL_NAMES}
        if self.B_bit is None:
            self.B_bit = {n: self.bit for n in MATMUL_NAMES}

    # -- reference cfg_modifier equivalent (example/test_all.py:48-78)
    def set_bits(self, w: int, a: int):
        self.bit = w
        self.w_bit = {n: w for n in CONV_FC_NAMES}
        self.a_bit = {n: a for n in CONV_FC_NAMES}
        self.A_bit = {n: a for n in MATMUL_NAMES}
        self.B_bit = {n: a for n in MATMUL_NAMES}
        return self

    def op_policy(self, module_type: str) -> OpPolicy:
        """Resolve the search policy of one op (reference get_module,
        configs/PTQ4ViT.py:51-80)."""
        if module_type == "qconv":
            kw = self.ptqsl_conv2d_kwargs
            quantizer = self.conv_quantizer or (
                "conv_channelwise" if self.conv_channelwise
                else "conv_layerwise")
            return OpPolicy(
                quantizer=quantizer,
                metric=kw["metric"], eq_alpha=kw["eq_alpha"],
                eq_beta=kw["eq_beta"], eq_n=kw["eq_n"],
                search_round=kw["search_round"],
                w_bit=self.w_bit["qconv"], a_bit=32,  # activation quant off
                n_V=kw.get("n_V", 1), n_H=kw.get("n_H", 1),
                init_layerwise=kw.get("init_layerwise", False))
        if module_type.startswith("qlinear"):
            kw = self.ptqsl_linear_kwargs
            n_V = kw.get("n_V", 1)
            if module_type == "qlinear_qkv":
                n_V *= 3  # q, k, v row blocks
            if module_type == "qlinear_classifier":
                n_V = 1
            quantizer = "linear"
            if module_type == "qlinear_MLP_2" and not self.no_postgelu:
                quantizer = "postgelu_linear"
            return OpPolicy(
                quantizer=quantizer, metric=kw["metric"],
                eq_alpha=kw["eq_alpha"], eq_beta=kw["eq_beta"],
                eq_n=kw["eq_n"], search_round=kw["search_round"],
                w_bit=self.w_bit[module_type], a_bit=self.a_bit[module_type],
                n_V=n_V, n_H=kw.get("n_H", 1), n_a=kw.get("n_a", 1),
                init_layerwise=kw.get("init_layerwise", False),
                bias_correction=kw.get("bias_correction", False))
        if module_type.startswith("qmatmul"):
            kw = self.ptqsl_matmul_kwargs
            quantizer = "matmul"
            if module_type == "qmatmul_scorev" and not self.no_softmax:
                quantizer = "sos_matmul"
            return OpPolicy(
                quantizer=quantizer, metric=kw["metric"],
                eq_alpha=kw["eq_alpha"], eq_beta=kw["eq_beta"],
                eq_n=kw["eq_n"], search_round=kw["search_round"],
                a_bit=self.A_bit[module_type], b_bit=self.B_bit[module_type],
                n_G_A=kw.get("n_G_A", 1), n_V_A=kw.get("n_V_A", 1),
                n_H_A=kw.get("n_H_A", 1), n_G_B=kw.get("n_G_B", 1),
                n_V_B=kw.get("n_V_B", 1), n_H_B=kw.get("n_H_B", 1),
                init_layerwise=kw.get("init_layerwise", False))
        raise NotImplementedError(f"unknown module type {module_type}")


def ptq4vit(**overrides) -> QuantConfig:
    """The full PTQ4ViT policy: hessian metric, alpha=0.01 (NOTE: the
    reference README says 0 but the shipped config has 0.01 —
    configs/PTQ4ViT.py:18 wins), 3 search rounds, twin quantizers on,
    channelwise conv, bias_correction flag set but inert in the batching
    pipeline (see calibrator docs)."""
    common = dict(metric="hessian", eq_alpha=0.01, eq_beta=1.2, eq_n=100,
                  search_round=3)
    cfg = QuantConfig(
        name="PTQ4ViT",
        ptqsl_conv2d_kwargs=dict(**common, n_V=1, n_H=1),
        ptqsl_linear_kwargs=dict(**common, n_V=1, n_H=1, n_a=1,
                                 bias_correction=True),
        ptqsl_matmul_kwargs=dict(**common, n_G_A=1, n_V_A=1, n_H_A=1,
                                 n_G_B=1, n_V_B=1, n_H_B=1),
        conv_channelwise=True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def base_ptq(**overrides) -> QuantConfig:
    """The BasePTQ baseline: cosine metric, alpha=0.5, single search round,
    no twin quantizers, layerwise EasyQuant conv (configs/BasePTQ.py)."""
    common = dict(metric="cosine", eq_alpha=0.5, eq_beta=1.2, eq_n=100,
                  search_round=1)
    cfg = QuantConfig(
        name="BasePTQ",
        ptqsl_conv2d_kwargs=dict(**common, n_V=1, n_H=1),
        ptqsl_linear_kwargs=dict(**common, n_V=1, n_H=1, n_a=1),
        ptqsl_matmul_kwargs=dict(**common, n_G_A=1, n_V_A=1, n_H_A=1,
                                 n_G_B=1, n_V_B=1, n_H_B=1),
        no_softmax=True, no_postgelu=True, conv_channelwise=False)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


_CONFIGS = {"PTQ4ViT": ptq4vit, "BasePTQ": base_ptq}


def get_config(name: str, **overrides) -> QuantConfig:
    """By-name loader (reference init_config, example/test_vit.py:82-90)."""
    if name not in _CONFIGS:
        raise NotImplementedError(f"Invalid config name {name}")
    return _CONFIGS[name](**overrides)


def apply_modifier(cfg: QuantConfig, *, bit_setting=(8, 8),
                   linear_ptq_setting=(1, 1, 1), metric: Optional[str] = None,
                   search_round: Optional[int] = None,
                   no_softmax: Optional[bool] = None,
                   no_postgelu: Optional[bool] = None) -> QuantConfig:
    """In-place config mutation mirroring the reference's cfg_modifier
    (example/test_all.py:48-78, example/test_ablation.py:42-82)."""
    cfg.set_bits(*bit_setting)
    n_V, n_H, n_a = linear_ptq_setting
    cfg.ptqsl_conv2d_kwargs.update(n_V=n_V, n_H=n_H, init_layerwise=False)
    cfg.ptqsl_linear_kwargs.update(n_V=n_V, n_H=n_H, n_a=n_a,
                                   init_layerwise=False)
    cfg.ptqsl_matmul_kwargs.update(init_layerwise=False)
    if metric is not None:
        for kw in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
                   cfg.ptqsl_matmul_kwargs):
            kw["metric"] = metric
    if search_round is not None:
        for kw in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
                   cfg.ptqsl_matmul_kwargs):
            kw["search_round"] = search_round
    if no_softmax is not None:
        cfg.no_softmax = no_softmax
    if no_postgelu is not None:
        cfg.no_postgelu = no_postgelu
    return cfg
