"""The H100 roofline: the three-term model, each kernel's work, and the
counter that reads a step's FLOPs and bytes (on meta, the CPU or the card)."""
from . import counting, kernel_model
from .counting import Counter
from .model import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_F32_FLOPS, PEAK_FLOPS,
                    POD_BW, RooflineReport, collective_s_by_axis,
                    model_flops)

__all__ = ["Counter", "HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_F32_FLOPS",
           "PEAK_FLOPS", "POD_BW", "RooflineReport", "collective_s_by_axis",
           "counting", "kernel_model", "model_flops"]
