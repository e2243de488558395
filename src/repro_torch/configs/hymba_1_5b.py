"""hymba-1.5b: 32L d1600, parallel attention + mamba heads, sliding-window
attention (global state via SSM) [arXiv:2411.13676]."""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
    head_dim=64, norm="rmsnorm", tie_embeddings=True,
    sliding_window=1024, max_seq_len=1048576,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
    head_dim=32, norm="rmsnorm", tie_embeddings=True, sliding_window=32,
    ssm=SSMConfig(state_dim=8, head_dim=32, expand=2, conv_width=4,
                  chunk=32),
)
