"""rwkv6-7b (Finch) — attention-free linear mixer with data-dependent decay.
64 WKV heads x 64 dims; channel-mix FFN (d_ff = 3.5x). The paper's
attention-dropout technique is INAPPLICABLE (no softmax score matrix) — see
DESIGN.md §Arch-applicability. [arXiv:2404.05892; hf]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,           # wkv heads = d_model / rwkv_head_dim
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        block_pattern=(AttentionKind.WKV,),
        ffn=FFNKind.RWKV_CHANNEL,
        norm=NormKind.LAYERNORM,
        rope=False,
        rwkv_head_dim=64,
        attn_dropout=0.0,  # no attention-score matrix exists
        source="arXiv:2404.05892; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=224,
        vocab_size=256,
        block_pattern=(AttentionKind.WKV,),
        ffn=FFNKind.RWKV_CHANNEL,
        norm=NormKind.LAYERNORM,
        rope=False,
        rwkv_head_dim=16,
        attn_dropout=0.0,
    )


register_arch("rwkv6-7b", full, reduced)
