"""whisper-base: 6L enc + 6L dec d512 8H, conv frontend stubbed to frame
embeddings [arXiv:2212.04356]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    norm="layernorm", tie_embeddings=True, n_encoder_layers=6,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    norm="layernorm", tie_embeddings=True, n_encoder_layers=2,
)
