"""mamba2-780m: 48L d1536 attn-free, SSD state 128 [arXiv:2405.21060,
hf:state-spaces/mamba2-780m]."""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=0, vocab_size=50280,
    norm="rmsnorm", tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    max_seq_len=1048576,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=512,
    norm="rmsnorm", tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                  chunk=32),
)
