"""DeepSeek-7B dense llama-arch (MHA: kv=32).  [arXiv:2401.02954; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=102400,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
