"""recurrentgemma-9b [hybrid]: 38L, d_model 4096, 16H (GQA kv=1 i.e. MQA,
head_dim 256), d_ff 12288, vocab 256000 — RG-LRU + local attention, ratio
1 attn : 2 recurrent (pattern (r, r, a) x12 + (r, r) tail = 38 layers).
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="lm",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("recurrent", "recurrent", "local"),
    tail=("recurrent", "recurrent"),
    window_size=2048,
    lru_width=4096,
    conv_width=4,
    act="gelu_glu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq_len=524288,     # recurrent state => unbounded context
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-9b-smoke",
    n_layers=5,             # (r,r,local) x1 + (r,r)
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    window_size=8,
    lru_width=64,
    max_seq_len=64,
).as_base()
