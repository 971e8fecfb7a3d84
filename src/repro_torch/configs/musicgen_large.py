"""musicgen-large — decoder-only transformer over EnCodec tokens. The
EnCodec frontend (and text conditioning cross-attention) is a STUB:
input_specs() provides precomputed frame embeddings; the backbone emits
2048-way codebook logits. MHA (kv == q heads), GELU FFN, LayerNorm.
[arXiv:2306.05284; hf]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.GELU,
        norm=NormKind.LAYERNORM,
        rope=False,  # musicgen uses learned sinusoidal offsets; stubbed as none
        frontend="embed_stub",
        source="arXiv:2306.05284; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-reduced",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.GELU,
        norm=NormKind.LAYERNORM,
        rope=False,
        frontend="embed_stub",
    )


register_arch("musicgen-large", full, reduced)
