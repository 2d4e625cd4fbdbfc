from .adamw import AdamW, AdamWConfig, schedule

__all__ = ["AdamW", "AdamWConfig", "schedule"]
