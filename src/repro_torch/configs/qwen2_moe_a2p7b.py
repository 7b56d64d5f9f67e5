"""qwen2-moe-a2.7b — GQA + shared/routed MoE. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

4 shared + 60 routed experts, top-4.  Experts are padded to a multiple
of tp; the padding experts' router columns are masked to -inf.
"""
from repro_torch.config.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936,
        qkv_bias=True,
        gated_mlp=True, act="silu", norm="rmsnorm",
        moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_ff_expert=1408),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced", family="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512,
        qkv_bias=True, gated_mlp=True, act="silu", norm="rmsnorm",
        moe=MoEConfig(n_routed=6, n_shared=2, top_k=2, d_ff_expert=128),
    )
