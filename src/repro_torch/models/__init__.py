from .api import Model
from .config import ArchConfig

__all__ = ["ArchConfig", "Model"]
