"""deepseek-v2-lite-16b — MLA + fine-grained MoE. [arXiv:2405.04434; hf]

MLA kv_lora=512; 2 shared + 64 routed experts, top-6; first layer dense.
"""
from repro_torch.config.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=192,  # qk_nope(128) + qk_rope(64)
        d_ff=1408, vocab_size=102400,
        gated_mlp=True, act="silu", norm="rmsnorm",
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
                      n_dense_layers=1, d_ff_dense=10944),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-reduced", family="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
        d_head=48, d_ff=128, vocab_size=512,
        gated_mlp=True, act="silu", norm="rmsnorm",
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff_expert=128,
                      n_dense_layers=1, d_ff_dense=256),
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
    )
