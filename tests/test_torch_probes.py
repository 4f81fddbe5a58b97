"""Host-side parts of the card probes and of the card check, on the CPU:
the SASS opcode counts and kernel names of ``scripts/torch_search_probe.py
ptxas`` on a canned ``cuobjdump -sass`` excerpt and canned mangled names;
``chip_smoke.py``'s adversarial relaxed inputs (they reach the bf16
chain's edges, and their softmax sums are exact in any order, so the
kernel is held to the plain version bitwise)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name, where="scripts"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, where, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ATTN = "_ZN12_GLOBAL__N_116attention_kernelILb0ELi64ELb1ELi2ELb1EEEvNS_8AttnArgsE"
Q8 = ("_ZN12_GLOBAL__N_112q8_tc_kernelILb0ELi1ELb1ELb1EEEv14CUtensorMap_stS1_"
      "NS_6Q8ArgsE")
SASS = f"""
	code for sm_90a
		Function : {ATTN}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                 /* 0x00000a00ff017b82 */
                                                                                          /* 0x000fe20000000800 */
        /*0010*/                   IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4 ;              /* 0x0000000c0804723c */
        /*0020*/                   I2FP.F32.S32 R5, R4 ;                                  /* 0x0000000400057245 */
        /*0030*/                   F2FP.BF16.F32.PACK_AB R6, R5, R4 ;                     /* 0x000000040506723e */
        /*0040*/                   F2FP.BF16.F32.PACK_AB R7, RZ, R4 ;                     /* 0x000000040507723e */
        /*0050*/               @P0 MUFU.EX2 R9, R9 ;                                      /* 0x0000000900090308 */
        /*0060*/              @!P1 FRND R10, R10 ;                                        /* 0x0000000a000a0307 */
        /*0070*/                   F2I.NTZ R11, R10 ;                                     /* 0x0000000a000b7305 */
        /*0080*/                   HMUL2.BF16_V2 R12, R6, R7 ;                            /* 0x000000070c0c7232 */
        /*0090*/                   HMNMX2.BF16_V2 R13, R12, R7, !PT ;                     /* 0x000000070c0d7240 */
        /*00a0*/                   HADD2.F32 R14, -RZ, R6.H0_H0 ;                         /* 0x20000006ff0e7230 */
        /*00b0*/                   F2F.F64.F32 R16, R5 ;                                  /* 0x0000000500107310 */
        /*00c0*/                   I2F.U32 R17, R4 ;                                      /* 0x0000000400117306 */
        /*00d0*/                   EXIT ;                                                 /* 0x000000000000794d */
		..........

		Function : {Q8}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], RZ, !UPT ;      /* 0x00e00000041879a6 */
        /*0010*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;                        /* 0x00000000000079af */
        /*0020*/                   IDP.4A.S8.S8 R3, R4, R5, R3 ;                          /* 0x0000000504037226 */
        /*0030*/                   HFMA2.MMA R2, -RZ, RZ, 0, 0 ;                          /* 0x00000000ff027435 */
        /*0038*/                   HFMA2.BF16_V2 R5, R2, R3, -RZ ;                        /* 0x0000000302057231 */
        /*0040*/            @!UP0 MUFU.TANH R3, R3 ;                                      /* 0x0000000300037308 */
        /*0050*/                   F2FP.BF16.F32.PACK_AB R4, R3, R2 ;                     /* 0x000000020304723e */
"""


def test_sass_counts_of_a_canned_excerpt():
    """Each opcode under its own key (F2FP apart from F2F, I2FP apart from
    I2F, IDP.4A, WARPGROUP.DEPBAR and HFMA2.BF16_V2 by their first
    modifier, HFMA2.MMA as HFMA2), predicated
    instructions counted, control words and headers not."""
    counts = _probe("torch_search_probe").sass_counts(SASS)
    assert list(counts) == [ATTN, Q8]
    a, q = counts[ATTN], counts[Q8]
    assert {k: v for k, v in a.items() if v} == dict(
        imma=1, i2fp=1, f2fp=2, mufu=1, frnd=1, f2i=1, hmul2=1, hmnmx2=1,
        hadd2=1, f2f=1, i2f=1)
    assert {k: v for k, v in q.items() if v} == dict(
        igmma=1, wg_depbar=1, idp4a=1, hfma2=1, hfma2_bf16=1, mufu=1,
        f2fp=1)


@pytest.mark.parametrize("mangled,name", [
    (ATTN, "attention_kernel<WINDOW=0, HDP=64, SOS=1, MODE=2, RELAXED=1>"),
    (Q8, "q8_tc_kernel<TWIN=0, OUTQ=1, GELU=1, RELAXED=1>"),
    ("_ZN12_GLOBAL__N_118fp32_scored_kernelILi2EEEvNS_6FArgsE",
     "fp32_scored_kernel<2>"),
    ("_ZN12_GLOBAL__N_112mm_tc_kernelILi48ELb1ELb0ELi2EEEvNS_6MmArgsE",
     "mm_tc_kernel<48, 1, 0, 2>"),
    ("_ZN12_GLOBAL__N_117window_fix_kernelEPf", "window_fix_kernel<>")],
    ids=["attention", "q8_tc", "fp32_scored", "mm_tc", "untemplated"])
def test_kernel_names_carry_their_template_flags(mangled, name):
    assert _probe("torch_search_probe").kernel_name(mangled) == name


def test_adversarial_attention_inputs_reach_the_bf16_chain_edges():
    """e in the bf16 subnormals and 0, p exactly at bf16(split), bf16 ties
    in the level products and rint's half-way points, each many times."""
    cov = _probe("chip_smoke", ".").adversarial_coverage("cpu")
    assert min(cov.values()) > 0, cov


@pytest.mark.parametrize("window", [False, True], ids=["b7", "b9"])
def test_adversarial_softmax_sums_are_exact_in_any_order(window):
    """Every row's e is either >= 2^-6 or <= 2^-100, and its float32 sum
    is the same in ascending, descending and a shuffled order."""
    cs = _probe("chip_smoke", ".")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    kw = dict(N=121, hd=32, seed=13, window=True) if window else {}
    qkv, qp1, sos, _, _, scale = cs.adversarial_attention_inputs("cpu", **kw)
    B, N, d3 = qkv.shape
    H = qp1.A_interval.shape[1]
    t = qkv.reshape(B, N, 3, H, d3 // 3 // H).permute(2, 0, 3, 1, 4)
    ph, _ = (sv.window_attn_scope(qp1, sos, H, scale) if window
             else sv.attn_scope(qp1, sos, H))
    e = cs.adversarial_e(t[0], t[1], ph, scale).reshape(-1, N)
    assert not ((e > 2.0 ** -100) & (e < 2.0 ** -6)).any()
    perm = torch.from_numpy(np.random.default_rng(0).permutation(N))
    sums = [torch.cumsum(x, -1)[:, -1] for x in (
        e.sort(-1).values, e.sort(-1, descending=True).values, e[:, perm])]
    assert torch.equal(sums[0], sums[1]) and torch.equal(sums[0], sums[2])


def test_adversarial_cases_run_on_the_cpu():
    """Each adversarial case is flagged bitwise, and its wrapper (the
    plain version on the CPU) gives its relaxed plain call's outputs."""
    cs = _probe("chip_smoke", ".")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    cases = cs.adversarial_cases(sv, "cpu")
    assert len(cases) == 7
    for kname, label, fn, plain, *_, exact, bitwise in cases:
        assert kname.endswith("_relaxed") and bitwise, label
        got, ref = fn(), plain()
        assert got.dtype == ref.dtype and torch.equal(got, ref), label
