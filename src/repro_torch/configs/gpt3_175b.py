"""gpt3-175b — the paper's GPT-3 comparison workload (1.06x speedup);
dense MHA, GELU FFN. [arXiv:2005.14165]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="gpt3-175b",
        family="dense",
        n_layers=96,
        d_model=12288,
        n_heads=96,
        n_kv_heads=96,
        head_dim=128,
        d_ff=49152,
        vocab_size=50257,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.GELU,
        norm=NormKind.LAYERNORM,
        rope=False,  # GPT-3 uses learned positions; stubbed as none
        qkv_bias=True,
        source="arXiv:2005.14165",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gpt3-175b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.GELU,
        norm=NormKind.LAYERNORM,
        rope=False,
        qkv_bias=True,
    )


register_arch("gpt3-175b", full, reduced)
