"""qwen2-72b — large dense GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_head=128, d_ff=29568, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0,
        gated_mlp=True, act="silu", norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-reduced", family="dense",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
        d_head=32, d_ff=512, vocab_size=512,
        qkv_bias=True, gated_mlp=True, act="silu", norm="rmsnorm",
    )
