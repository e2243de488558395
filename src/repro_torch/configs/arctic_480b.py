"""arctic-480b: 35L d7168 56H kv8, 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    head_dim=128, norm="rmsnorm", tie_embeddings=False,
    max_seq_len=32768,
    moe=MoEConfig(n_experts=128, top_k=2, d_expert_ff=4864,
                  dense_residual=True),
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
    norm="rmsnorm",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=256,
                  dense_residual=True),
)
