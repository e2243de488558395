"""mistral-nemo-12b: 40L d5120 32H kv8, head_dim 128, 128k ctx
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
    head_dim=128, norm="rmsnorm", tie_embeddings=False,
    rope_theta=1e6, max_seq_len=131072,
)

SMOKE = ModelConfig(
    name="nemo-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=384, vocab_size=512,
    head_dim=32, norm="rmsnorm",
)
