"""llama4-scout-17b-a16e [moe]: 48L, d_model 5120, 40H (GQA kv=8, head_dim
128), d_ff 8192, vocab 202048, MoE 16 experts top-1 — iRoPE-style pattern:
3 chunked-local layers : 1 global layer (the text backbone; the real
model's multimodal frontend is out of scope, as in the reference).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="lm",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=("local_moe", "local_moe", "local_moe", "moe"),
    window_size=8192,            # chunked-local attention span
    n_experts=16,
    top_k=1,
    capacity_factor=1.25,
    act="silu_glu",
    tie_embeddings=False,
    rope_theta=5e5,
    max_seq_len=524288,
)

SMOKE = CONFIG.replace(
    name="llama4-scout-smoke",
    n_layers=4,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_head=12,
    d_ff=96,
    vocab_size=512,
    n_experts=4,
    top_k=1,
    window_size=8,
    max_seq_len=64,
).as_base()
