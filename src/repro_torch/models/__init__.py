"""Model zoo of the port: dense and MoE attention, RG-LRU hybrid and RWKV-6
stacks, the vision stub and the encoder-decoder."""
from .config import ModelConfig
from .model import Model, init_params
from .params import from_jax_params

__all__ = ["Model", "ModelConfig", "from_jax_params", "init_params"]
