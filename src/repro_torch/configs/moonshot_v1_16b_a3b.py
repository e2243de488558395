"""moonshot-v1-16b-a3b (Moonlight): 48L d2048, 64-expert top-6 MoE + 2
shared experts [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840,
    norm="rmsnorm", tie_embeddings=False, max_seq_len=131072,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408,
                  n_shared_experts=2),
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    norm="rmsnorm",
    moe=MoEConfig(n_experts=8, top_k=3, d_expert_ff=128,
                  n_shared_experts=1),
)
