from . import fakequant, metrics, qparams
from .fakequant import (GELU_NEG_CLIP, candidate_grid, fake_quant,
                        fake_quant_act_grouped, fake_quant_matmul_operand,
                        fake_quant_weight_blocked, qmax_for_bit,
                        sos_quant_softmax, sos_split_grid,
                        twin_quant_post_gelu)
from .metrics import METRICS, similarity
from .qparams import ConvQP, LinearQP, MatMulQP, apply_linear, apply_matmul
