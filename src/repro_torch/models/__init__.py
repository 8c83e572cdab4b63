"""Model zoo of the port (dense ``"global"`` blocks so far)."""
from .config import ModelConfig
from .model import Model, init_params
from .params import from_jax_params

__all__ = ["Model", "ModelConfig", "from_jax_params", "init_params"]
