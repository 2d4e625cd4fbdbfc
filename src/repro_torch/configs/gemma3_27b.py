"""Gemma-3 27B dense with 5:1 local(sliding-window):global attention, 128k
context.  [hf:google/gemma-3-1b-pt; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    sliding_window=1024, global_every=6,     # LLLLLG pattern
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, sliding_window=8, global_every=3,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
