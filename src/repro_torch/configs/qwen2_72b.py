"""qwen2-72b — dense GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        qkv_bias=True,
        rope=True,
        rope_theta=1_000_000.0,
        source="arXiv:2407.10671; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-reduced",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=256,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        qkv_bias=True,
        rope=True,
    )


register_arch("qwen2-72b", full, reduced)
