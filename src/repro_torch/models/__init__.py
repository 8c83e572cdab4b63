"""Model zoo of the port: dense attention, RG-LRU hybrid and RWKV-6 stacks."""
from .config import ModelConfig
from .model import Model, init_params
from .params import from_jax_params

__all__ = ["Model", "ModelConfig", "from_jax_params", "init_params"]
