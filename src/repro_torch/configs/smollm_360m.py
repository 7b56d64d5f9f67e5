"""smollm-360m — llama-arch small dense LM. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab_size=49152,
        gated_mlp=True, act="silu", norm="rmsnorm", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-reduced", family="dense",
        n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        gated_mlp=True, act="silu", norm="rmsnorm", tie_embeddings=True,
    )
