"""mamba2-370m — pure SSM (SSD / state-space duality). [arXiv:2405.21060; unverified]

Attention-free: one sync point per block, so SPD does not apply."""
from repro_torch.config.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        norm="rmsnorm",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-reduced", family="ssm",
        n_layers=4, d_model=128, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512,
        norm="rmsnorm",
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32,
                      chunk_size=16),
    )
