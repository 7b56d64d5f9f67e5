"""llama2-7b — the paper's primary experimental model (no-bias SPD variant)."""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab_size=32000,
        gated_mlp=True, act="silu", norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b-reduced", family="dense",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=8,
        d_ff=384, vocab_size=512,
        gated_mlp=True, act="silu", norm="rmsnorm",
    )
