"""recurrentgemma-9b — Griffin hybrid: RG-LRU recurrent blocks and local
(sliding-window 2048) attention in a 2:1 pattern (R, R, A). MQA (kv=1).
38 layers = 12 full (R,R,A) super-blocks + 2 trailing recurrent layers.
[arXiv:2402.19427; unverified]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=(AttentionKind.RECURRENT, AttentionKind.RECURRENT,
                       AttentionKind.LOCAL),
        ffn=FFNKind.GEGLU,  # gemma-family gated-GELU FFN
        norm=NormKind.RMSNORM,
        rope=True,
        local_window=2048,
        tie_embeddings=True,
        source="arXiv:2402.19427; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced",
        family="hybrid",
        n_layers=4,  # R, R, A, R — exercises both block kinds + remainder
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=(AttentionKind.RECURRENT, AttentionKind.RECURRENT,
                       AttentionKind.LOCAL),
        ffn=FFNKind.GEGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        local_window=32,
        tie_embeddings=True,
    )


register_arch("recurrentgemma-9b", full, reduced)
