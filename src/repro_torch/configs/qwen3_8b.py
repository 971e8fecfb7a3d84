"""qwen3-8b — dense GQA with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        qk_norm=True,
        rope=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-reduced",
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
        qk_norm=True,
        rope=True,
    )


register_arch("qwen3-8b", full, reduced)
