"""Whisper-medium enc-dec; conv audio frontend is a stub (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]
Shapes apply to the decoder; encoder fixed at 1500 frames."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, mlp_act="gelu",
    enc_layers=24, enc_len=1500,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, enc_len=32, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
    param_dtype="float32", compute_dtype="float32", remat="none",
)
