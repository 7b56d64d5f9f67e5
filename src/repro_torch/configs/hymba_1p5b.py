"""hymba-1.5b — hybrid: parallel attention + mamba heads. [arXiv:2411.13676; hf]

Sliding-window attention everywhere except 3 global layers (first,
middle, last); SSM heads run in parallel inside the same mixer.
"""
from repro_torch.config.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_head=64, d_ff=5504, vocab_size=32001,
        attn_window=1024, global_attn_layers=(0, 15, 31),
        gated_mlp=True, act="silu", norm="rmsnorm",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=1, head_dim=64,
                      chunk_size=256),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-reduced", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=32, d_ff=256, vocab_size=512,
        attn_window=32, global_attn_layers=(0, 3),
        gated_mlp=True, act="silu", norm="rmsnorm",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=1, head_dim=32,
                      chunk_size=16),
    )
