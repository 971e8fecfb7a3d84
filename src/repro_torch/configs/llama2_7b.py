"""llama2-7b — the paper's own headline workload (1.14x speedup); used by
the perf-model benchmarks and the end-to-end examples.
[arXiv:2307.09288; hf]"""
from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig, NormKind
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=32000,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
        source="arXiv:2307.09288; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=(AttentionKind.FULL,),
        ffn=FFNKind.SWIGLU,
        norm=NormKind.RMSNORM,
        rope=True,
    )


register_arch("llama2-7b", full, reduced)
