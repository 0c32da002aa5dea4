"""smollm-360m [dense]: 32L, d_model 960, 15H (GQA kv=5, head_dim 64),
d_ff 2560, vocab 49152 — llama-arch small. [hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="lm",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_head=64,
    d_ff=2560,
    vocab_size=49152,
    pattern=("attn",),
    act="silu_glu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=32768,
)

SMOKE = CONFIG.replace(
    name="smollm-360m-smoke",
    n_layers=3,
    d_model=60,
    n_heads=3,
    n_kv_heads=1,
    d_head=20,
    d_ff=160,
    vocab_size=512,
    max_seq_len=64,
).as_base()
