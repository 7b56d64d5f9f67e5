"""musicgen-medium — decoder-only over EnCodec tokens (port of
repro/configs/musicgen_medium.py).

The EnCodec frontend is a stub, as in the reference: callers pass
precomputed frame embeddings.  The backbone is a pre-LN transformer
decoder with biased linear layers, LayerNorm and GELU (tanh form): the
SPD bias block (Fig. 3b) under MHA.
"""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        qkv_bias=True, o_bias=True, mlp_bias=True,
        gated_mlp=False, act="gelu", norm="layernorm",
        frontend="audio_stub", frontend_dim=768, frontend_len=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-reduced", family="audio",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=8,
        d_ff=384, vocab_size=256,
        qkv_bias=True, o_bias=True, mlp_bias=True,
        gated_mlp=False, act="gelu", norm="layernorm",
        frontend="audio_stub", frontend_dim=32, frontend_len=4,
    )
