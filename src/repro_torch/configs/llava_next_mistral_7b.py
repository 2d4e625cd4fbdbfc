"""LLaVA-NeXT (Mistral-7B backbone) VLM; anyres vision tower is a stub
(input_specs provides patch features (B, n_patches, 1024) fed through the
projector).  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    n_patches=2880,          # anyres: 5 tiles x 576 patches
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_patches=8,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
