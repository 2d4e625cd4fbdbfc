from .ops import (FlashAttention, attention_backward_reference,
                  attention_reference, flash_attention)

__all__ = ["FlashAttention", "attention_backward_reference",
           "attention_reference", "flash_attention"]
