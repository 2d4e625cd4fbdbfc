from .ops import (GroupedFFN, grouped_ffn, grouped_ffn_backward_reference,
                  grouped_ffn_reference)

__all__ = ["GroupedFFN", "grouped_ffn", "grouped_ffn_backward_reference",
           "grouped_ffn_reference"]
