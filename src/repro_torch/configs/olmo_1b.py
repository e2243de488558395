"""olmo-1b: 16L d2048 16H MHA, non-parametric LN [arXiv:2402.00838]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=50304,
    norm="nonparametric_ln", tie_embeddings=True, max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="olmo-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512,
    norm="nonparametric_ln", tie_embeddings=True,
)
