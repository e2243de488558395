"""qwen2.5-1.5b: the paper's llama-bench model (section 4.1): 28L d1536
12Q/2KV GQA, QKV bias, tied embeddings [hf:Qwen/Qwen2.5-1.5B]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
    qkv_bias=True, norm="rmsnorm", tie_embeddings=True,
    rope_theta=1e6, max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="qwen1.5b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=384, vocab_size=512,
    qkv_bias=True, norm="rmsnorm", tie_embeddings=True,
)
