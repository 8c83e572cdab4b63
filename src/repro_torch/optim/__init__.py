from . import adamw
from .adamw import AdamWConfig
