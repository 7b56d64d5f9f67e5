"""opt-6.7b — the paper's biased-linear model (SPD bias variant, Fig 3b)."""
from repro_torch.config.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="opt-6.7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=16384, vocab_size=50272,
        qkv_bias=True, o_bias=True, mlp_bias=True,
        gated_mlp=False, act="relu", norm="layernorm",
        pos_emb="learned", max_seq_len=4096,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="opt-6.7b-reduced", family="dense",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=8,
        d_ff=384, vocab_size=512,
        qkv_bias=True, o_bias=True, mlp_bias=True,
        gated_mlp=False, act="relu", norm="layernorm",
        pos_emb="learned", max_seq_len=512,
    )
