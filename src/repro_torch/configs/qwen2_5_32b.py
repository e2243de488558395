"""qwen2.5-32b: 64L d5120 40H kv8, QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=27648, vocab_size=152064,
    head_dim=128, qkv_bias=True, norm="rmsnorm", tie_embeddings=False,
    rope_theta=1e6, max_seq_len=131072,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense", n_layers=2, d_model=160,
    n_heads=5, n_kv_heads=1, d_ff=448, vocab_size=512,
    head_dim=32, qkv_bias=True, norm="rmsnorm",
)
