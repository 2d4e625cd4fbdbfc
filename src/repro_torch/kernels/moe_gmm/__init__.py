from .ops import grouped_ffn, grouped_ffn_reference

__all__ = ["grouped_ffn", "grouped_ffn_reference"]
