"""Model family of the port: BidPointFlowNet (teacher wiring), the Bridge
of bridge distillation, their configuration, the weight bridge from the
JAX package's variables and the importer of the reference's .pth files."""

from .bid_pointflow import BidPointFlowNet, check_config
from .bridge import Bridge
from .config import PRESETS, ModelConfig, tiny_config
from .jax_bridge import params_from_jax
from .torch_import import convert_state_dict, load_torch_checkpoint

__all__ = ["BidPointFlowNet", "Bridge", "check_config", "PRESETS",
           "ModelConfig", "tiny_config", "params_from_jax",
           "convert_state_dict", "load_torch_checkpoint"]
