from . import vit
from .registry import MODEL_ZOO, Net, get_net, model_config, net_from_config
