"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — DeepSeek-style fine-grained
MoE: 64 routed experts top-6, 2 shared experts, first layer dense.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.config.base import (
    AttentionKind,
    FFNKind,
    ModelConfig,
    MoEConfig,
    NormKind,
)
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            d_ff_expert=1408,
            n_shared_experts=2,
            first_dense_layers=1,
            capacity_factor=1.25,
        ),
        source="hf:moonshotai/Moonlight-16B-A3B; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-reduced",
        family="moe",
        n_layers=3,  # exercises the first-dense-layer path + 2 MoE layers
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        moe=MoEConfig(
            n_experts=8,
            top_k=3,
            d_ff_expert=96,
            n_shared_experts=2,
            first_dense_layers=1,
            capacity_factor=8.0,  # effectively dropless: keeps reduced-
            # config smoke tests decode-consistent (no capacity drops)
        ),
    )


register_arch("moonshot-v1-16b-a3b", full, reduced)
