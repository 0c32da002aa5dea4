"""mup-gpt — the paper's own model family: a pre-LN GPT used for the Fig. 1 /
Fig. 4 / Fig. 7 experiments and the muTransfer examples.  CONFIG is the
"target" (wide) member; `.scaled(f)` derives the family.
Base shape anchored at width 256 like the paper's proxy models."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mup-gpt",
    family="lm",
    n_layers=8,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=2048,
    pattern=("attn",),
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=512,
    # muP base shape = the width-256 proxy (the paper's tuning model)
    base_d_model=256,
    base_n_heads=4,
    base_n_kv_heads=4,
    base_d_head=64,
    base_d_ff=1024,
)

SMOKE = CONFIG.replace(
    name="mup-gpt-smoke",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab_size=256,
    max_seq_len=64,
    base_d_model=64,
    base_n_heads=2,
    base_n_kv_heads=2,
    base_d_head=32,
    base_d_ff=256,
)
