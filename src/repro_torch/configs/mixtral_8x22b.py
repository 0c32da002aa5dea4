"""mixtral-8x22b [moe]: 56L, d_model 6144, 48H (GQA kv=8, head_dim 128),
d_ff 16384, vocab 32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="lm",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=("local_moe",),
    window_size=4096,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    act="silu_glu",
    tie_embeddings=False,
    rope_theta=1e6,
    max_seq_len=524288,         # SWA => sub-quadratic long context
)

SMOKE = CONFIG.replace(
    name="mixtral-8x22b-smoke",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_head=12,
    d_ff=96,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    window_size=8,
    max_seq_len=64,
).as_base()
