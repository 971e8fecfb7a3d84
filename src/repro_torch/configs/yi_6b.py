"""yi-6b — llama-arch GQA dense transformer. [arXiv:2403.04652; hf]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        rope_theta=5_000_000.0,
        source="arXiv:2403.04652; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
    )


register_arch("yi-6b", full, reduced)
