"""stablelm-1.6b — dense, LayerNorm, partial rotary. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        qkv_bias=True, rope_fraction=0.25,
        gated_mlp=True, act="silu", norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-reduced", family="dense",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=8,
        d_ff=384, vocab_size=512,
        qkv_bias=True, rope_fraction=0.25,
        gated_mlp=True, act="silu", norm="layernorm",
    )
