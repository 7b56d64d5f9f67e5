"""qwen3-1.7b — dense GQA with qk-norm. [hf:Qwen/Qwen3-1.7B family; hf]"""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
        d_head=128, d_ff=6144, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        gated_mlp=True, act="silu", norm="rmsnorm", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-reduced", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=32, d_ff=384, vocab_size=512,
        qk_norm=True, gated_mlp=True, act="silu", norm="rmsnorm",
        tie_embeddings=True,
    )
