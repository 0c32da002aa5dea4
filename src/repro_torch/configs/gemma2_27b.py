"""gemma2-27b [dense]: 46L, d_model 4608, 32H (GQA kv=16, head_dim 128),
d_ff 36864, vocab 256000 — local+global alternating attention, logit
softcaps (attn 50, final 30), pre+post norms. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="lm",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=("local", "attn"),        # alternating sliding-window / global
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
    name="gemma2-27b-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    window_size=8,
    max_seq_len=64,
).as_base()
