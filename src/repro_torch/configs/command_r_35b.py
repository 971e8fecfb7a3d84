"""command-r-35b — dense GQA, LayerNorm, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab_size=256000,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.LAYERNORM,
        qkv_bias=False,
        rope=True,
        rope_theta=8_000_000.0,
        tie_embeddings=True,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-reduced",
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
        norm=NormKind.LAYERNORM,
        rope=True,
        tie_embeddings=True,
    )


register_arch("command-r-35b", full, reduced)
