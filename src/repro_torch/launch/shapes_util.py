"""Re-export of the assigned shape table (kept importable without configs)."""
from ..configs.shapes import SHAPES, ShapeSpec, applicable

__all__ = ["SHAPES", "ShapeSpec", "applicable"]
