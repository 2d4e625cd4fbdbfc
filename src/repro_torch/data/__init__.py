from .pipeline import (MemmapCorpus, PrefetchingLoader, SyntheticCorpus,
                       WowPrefetchPlanner)

__all__ = ["MemmapCorpus", "PrefetchingLoader", "SyntheticCorpus",
           "WowPrefetchPlanner"]
