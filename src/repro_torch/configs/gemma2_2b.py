"""gemma2-2b [dense]: 26L, d_model 2304, 8H (GQA kv=4, head_dim 256),
d_ff 9216, vocab 256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="lm",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=("local", "attn"),
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_attn_norm=True,
    act="gelu_glu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=32768,
)

SMOKE = CONFIG.replace(
    name="gemma2-2b-smoke",
    n_layers=4,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_head=12,
    d_ff=96,
    vocab_size=512,
    window_size=8,
    max_seq_len=64,
).as_base()
