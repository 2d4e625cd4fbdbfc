"""The scheduler half's one accelerator twin: the drain's winner reduction."""
from .copmatrix import torch_winner

__all__ = ["torch_winner"]
