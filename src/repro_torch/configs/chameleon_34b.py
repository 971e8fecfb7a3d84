"""chameleon-34b — early-fusion VLM; VQ image tokens share the text vocab so
the backbone is a dense transformer with qk-norm. The modality frontend
(VQ-GAN tokenizer) is a STUB: input_specs() provides precomputed token
embeddings. [arXiv:2405.09818; unverified]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        qk_norm=True,  # chameleon uses qk-norm for stability
        rope=True,
        frontend="embed_stub",
        source="arXiv:2405.09818; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced",
        family="vlm",
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
        frontend="embed_stub",
    )


register_arch("chameleon-34b", full, reduced)
