from .ops import (SSDIntraChunk, ssd_intra_chunk,
                  ssd_intra_chunk_backward_reference,
                  ssd_intra_chunk_reference, ssd_reference)

__all__ = ["SSDIntraChunk", "ssd_intra_chunk",
           "ssd_intra_chunk_backward_reference", "ssd_intra_chunk_reference",
           "ssd_reference"]
