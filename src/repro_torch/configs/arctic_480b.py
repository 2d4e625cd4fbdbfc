"""Snowflake Arctic-480B: 128-expert top-2 MoE + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_dense_ff=4864,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, n_experts=4, top_k=2, moe_dense_ff=96,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
