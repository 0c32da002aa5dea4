"""mamba2-130m [ssm]: 24L, d_model 768, attention-free, vocab 50280,
ssm_state 128 — SSD (state-space duality), d_inner = 2*d_model = 1536,
head_dim 64 (24 SSD heads). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="lm",
    n_layers=24,
    d_model=768,
    n_heads=1,                   # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,                      # no separate MLP in mamba blocks
    vocab_size=50280,
    pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    act="gelu",
    tie_embeddings=True,
    rope_theta=0.0,
    max_seq_len=524288,          # O(1) state => unbounded context
)

SMOKE = CONFIG.replace(
    name="mamba2-130m-smoke",
    n_layers=3,
    d_model=64,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    vocab_size=512,
    max_seq_len=64,
).as_base()
