from .policy import (OpPolicy, QuantConfig, base_ptq, get_config, ptq4vit,
                     apply_modifier)
