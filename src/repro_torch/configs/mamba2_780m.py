"""Mamba2-780M attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    vocab=512,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
