from .ops import attention_reference, flash_attention

__all__ = ["attention_reference", "flash_attention"]
