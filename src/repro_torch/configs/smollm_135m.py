"""smollm-135m [dense]: 30L, d_model 576, 9H (GQA kv=3, head_dim 64),
d_ff 1536, vocab 49152 — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="lm",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_head=64,
    d_ff=1536,
    vocab_size=49152,
    pattern=("attn",),
    act="silu_glu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=32768,
)

SMOKE = CONFIG.replace(
    name="smollm-135m-smoke",
    n_layers=3,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=64,
).as_base()
