"""Granite-34B-code dense, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, mlp_act="gelu",   # GPT-BigCode-style MLP
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
