"""Zamba2-2.7B hybrid: Mamba2 backbone + shared attention block every 6
layers.  [arXiv:2411.15242; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    attn_every=6,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    attn_every=2,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
