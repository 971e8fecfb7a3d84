"""arctic-480b — dense-MoE hybrid: 128 experts top-2 in parallel with a
dense residual FFN. [hf:Snowflake/snowflake-arctic-base; hf]"""
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
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        moe=MoEConfig(
            n_experts=128,
            top_k=2,
            d_ff_expert=4864,
            dense_residual=True,
            dense_residual_ff=4864,
            capacity_factor=1.25,
        ),
        source="hf:Snowflake/snowflake-arctic-base; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=96,
            dense_residual=True,
            dense_residual_ff=96,
            capacity_factor=8.0,  # effectively dropless for smoke tests
        ),
    )


register_arch("arctic-480b", full, reduced)
