from .ops import ssd_intra_chunk, ssd_intra_chunk_reference, ssd_reference

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_reference", "ssd_reference"]
