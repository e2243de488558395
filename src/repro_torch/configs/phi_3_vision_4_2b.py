"""phi-3-vision-4.2b: phi3-mini backbone + CLIP stub (precomputed patch
embeddings as a 256-token prefix) [hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064,
    norm="rmsnorm", tie_embeddings=False, max_seq_len=131072,
    n_vision_tokens=256,
)

SMOKE = ModelConfig(
    name="phi3v-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    norm="rmsnorm", n_vision_tokens=8,
)
