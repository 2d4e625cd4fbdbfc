"""Llama-4 Scout 17B-active/16E: 16-expert top-1 MoE with shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  Early-fusion multimodal
frontend is out of scope; text backbone only."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, shared_expert_ff=8192,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, top_k=1, shared_expert_ff=128,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
