"""internvl2-1b — InternViT (stub) + Qwen2-0.5B LM backbone (port of
repro/configs/internvl2_1b.py).

The vision frontend is a stub, as in the reference: callers pass
precomputed patch embeddings (B, frontend_len, frontend_dim), which the
`front` leaf projects and prepends to the token stream
(core/model.forward_seq).
"""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_head=64, d_ff=4864, vocab_size=151655,
        qkv_bias=True, rope_theta=1_000_000.0,
        gated_mlp=True, act="silu", norm="rmsnorm", tie_embeddings=True,
        frontend="vision_stub", frontend_dim=1024, frontend_len=256,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-reduced", family="vlm",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=32, d_ff=384, vocab_size=512,
        qkv_bias=True, gated_mlp=True, act="silu", norm="rmsnorm",
        tie_embeddings=True, frontend="vision_stub",
        frontend_dim=64, frontend_len=8,
    )
