"""qwen1.5-110b: 80L d8192 64H GQA kv8, QKV bias [hf:Qwen/Qwen1.5-0.5B].

The port serves it at SMOKE width only: its bf16 weights (about 222 GB)
do not fit one 80 GB card."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab_size=152064,
    head_dim=128, qkv_bias=True, norm="rmsnorm", tie_embeddings=False,
    rope_theta=1e6, max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=384, vocab_size=512,
    qkv_bias=True, norm="rmsnorm", tie_embeddings=False,
)
