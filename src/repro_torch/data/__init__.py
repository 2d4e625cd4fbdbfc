from .pipeline import PrefetchingLoader, SyntheticCorpus

__all__ = ["PrefetchingLoader", "SyntheticCorpus"]
