"""Model family of the port: BidPointFlowNet (teacher wiring), its
configuration and the weight bridge from the JAX package's variables."""

from .bid_pointflow import BidPointFlowNet, check_config
from .config import PRESETS, ModelConfig, tiny_config
from .jax_bridge import params_from_jax

__all__ = ["BidPointFlowNet", "check_config", "PRESETS", "ModelConfig",
           "tiny_config", "params_from_jax"]
