"""Core configuration dataclasses.

Everything is a frozen dataclass so configs hash and can key step caches.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class AttentionKind(str, enum.Enum):
    FULL = "full"          # full (causal) softmax attention
    LOCAL = "local"        # sliding-window softmax attention
    RECURRENT = "recurrent"  # RG-LRU recurrent block (no score matrix)
    WKV = "wkv"            # RWKV6 linear-attention mixer (no score matrix)


class FFNKind(str, enum.Enum):
    SWIGLU = "swiglu"
    GEGLU = "geglu"
    GELU = "gelu"          # plain 2-matmul GELU MLP
    RWKV_CHANNEL = "rwkv_channel"  # RWKV channel-mix (relu^2 gated)


class NormKind(str, enum.Enum):
    RMSNORM = "rmsnorm"
    LAYERNORM = "layernorm"


class StepKind(str, enum.Enum):
    TRAIN = "train"
    PREFILL = "prefill"
    DECODE = "decode"


# A block pattern is a tuple of AttentionKind drawn on repeat over layers,
# e.g. Griffin = (RECURRENT, RECURRENT, LOCAL).
BlockPattern = Tuple[AttentionKind, ...]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    # DeepSeek-style: the first k layers use a dense FFN instead of MoE.
    first_dense_layers: int = 0
    # Arctic-style: a dense FFN runs in parallel with the routed experts.
    dense_residual: bool = False
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


# Producer-GEMM sites for DropoutPlanConfig.site. CARRIED sites pipeline
# layer l+1's mask through the transformer scan (generated under one of
# layer l's post-attention GEMMs); the others generate in-layer.
DROPOUT_SITES = ("xla", "qkv", "prev_gemm", "ffn_up", "ffn_down", "auto")
CARRIED_DROPOUT_SITES = ("prev_gemm", "ffn_up", "ffn_down")

# Operand dtypes for the fused producer GEMM (gemm_dtype knob).
GEMM_DTYPES = ("f32", "bf16", "fp8")


@dataclasses.dataclass(frozen=True)
class DropoutPlanConfig:
    """The paper's technique as a config-level feature.

    mode:
      "fused"   — RNG fused into the attention computation (paper baseline)
      "overlap" — RNG decoupled, generated at the producer-GEMM site and
                  consumed as packed bits by attention (paper technique)
      "none"    — dropout disabled

    site (overlap mode only) — WHICH producer GEMM physically hosts the
    RNG. Every site emits bit-identical masks for the same
    (seed, salt, layer, step); they differ only in where the bits are
    scheduled:
      "xla"       — mask generated by XLA ops next to the QKV projection
                    (decoupled but not kernel-fused; the scheduler hoists)
      "qkv"       — mask generated INSIDE the fused QKV-GEMM Pallas kernel
                    (MXU ∥ VPU; falls back to the standalone philox kernel
                    when the GEMM cannot host it — paper Region 3)
      "prev_gemm" — layer l+1's mask generated under layer l's out-proj
                    GEMM and carried through the layer scan (the paper's
                    "previous GEMM layers" site; cross-layer pipelining)
      "ffn_up"    — layer l+1's mask under layer l's FFN gate+up GEMM
                    (the block's largest GEMM for gated FFNs; carried)
      "ffn_down"  — layer l+1's mask under layer l's FFN down GEMM
                    (carried)
      "auto"      — core/producer.py picks the host GEMM per model/shape
                    by Region-1 headroom (perfmodel.gemm_host_headroom)

    gemm_dtype — operand precision of the FUSED producer GEMM ("f32" |
    "bf16" | "fp8"). "fp8" runs the per-tile-scaled e4m3 kernel — the
    paper's measured serving regime; the mask bits do not depend on the
    host dtype.
    """
    mode: str = "none"
    p: float = 0.1
    philox_rounds: int = 7  # 3 | 5 | 7 | 10
    seed: int = 0
    site: str = "xla"       # one of DROPOUT_SITES
    # 32: one u32 draw per element (paper-faithful). 8: one byte per
    # element — 4 elements per Philox word, 4x less RNG compute/traffic;
    # p quantizes to 1/256 (beyond-paper optimization, see §Perf).
    philox_bits: int = 32
    gemm_dtype: str = "f32"  # one of GEMM_DTYPES
    # "auto": the schedule compiler plans zero-HBM replay consumption
    # (flash kernels re-derive keep bits in-register from the planned
    # position-based counters) whenever the feasibility gates hold —
    # pallas attention, 32-bit Philox, 128-tileable seq, kv-divisible
    # head sharding. "off": always materialize the packed plane
    # (premask consumption). Bits are identical either way; the knob
    # only moves WHERE they are realized.
    attn_replay: str = "auto"

    def __post_init__(self):
        # Bad knob values fail at construction, not deep inside the
        # schedule compiler / trace.
        if self.site not in DROPOUT_SITES:
            raise ValueError(
                f"DropoutPlanConfig.site={self.site!r}; expected one of "
                f"{DROPOUT_SITES}")
        if self.gemm_dtype not in GEMM_DTYPES:
            raise ValueError(
                f"DropoutPlanConfig.gemm_dtype={self.gemm_dtype!r}; "
                f"expected one of {GEMM_DTYPES}")
        if self.philox_bits not in (8, 32):
            raise ValueError(
                f"DropoutPlanConfig.philox_bits={self.philox_bits!r}; "
                "expected 8 or 32")
        if self.attn_replay not in ("auto", "off"):
            raise ValueError(
                f"DropoutPlanConfig.attn_replay={self.attn_replay!r}; "
                "expected 'auto' or 'off'")
        from repro_torch.kernels.philox_common import SUPPORTED_PHILOX_ROUNDS
        if self.philox_rounds not in SUPPORTED_PHILOX_ROUNDS:
            raise ValueError(
                f"DropoutPlanConfig.philox_rounds={self.philox_rounds!r};"
                f" expected one of {SUPPORTED_PHILOX_ROUNDS} (every "
                "producer site unrolls the same round count, so an "
                "unsupported value would diverge between kernels)")

    @property
    def enabled(self) -> bool:
        return self.mode != "none" and self.p > 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    block_pattern: BlockPattern = (AttentionKind.FULL,)
    ffn: FFNKind = FFNKind.SWIGLU
    norm: NormKind = NormKind.RMSNORM
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    local_window: int = 0           # >0 for LOCAL attention layers
    moe: Optional[MoEConfig] = None
    # RWKV6 specifics
    rwkv_head_dim: int = 64
    # frontend: "token" (ids -> embedding table) or "embed_stub" (the
    # modality frontend is stubbed; inputs are precomputed frame/patch
    # embeddings of shape (B, S, d_model)).
    frontend: str = "token"
    tie_embeddings: bool = False
    attn_dropout: float = 0.1       # attention-score dropout (paper target)
    resid_dropout: float = 0.0
    # max positions for rope tables / local-window caches
    max_seq_len: int = 1 << 20
    # source tag from the assignment table
    source: str = ""

    def layer_kinds(self) -> Tuple[AttentionKind, ...]:
        """Expand block_pattern over n_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def attention_layer_indices(self) -> Tuple[int, ...]:
        return tuple(
            i for i, k in enumerate(self.layer_kinds())
            if k in (AttentionKind.FULL, AttentionKind.LOCAL)
        )

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        nq, nkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds():
            if kind in (AttentionKind.FULL, AttentionKind.LOCAL):
                total += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            elif kind == AttentionKind.RECURRENT:
                # RG block: 2 up-proj branches (d->r), conv1d(4), rg-lru
                # gates (2 per-channel r-dim mats), down-proj (r->d)
                r = self.d_model  # recurrent width == d_model here
                total += 2 * d * r + 4 * r + 2 * r * r // 8 + r * d
            elif kind == AttentionKind.WKV:
                total += 4 * d * d + d * d  # r,k,v,g,o projections approx
            # FFN / MoE
            if self.moe is not None:
                m = self.moe
                total += d * m.n_experts  # router
                total += m.n_experts * 3 * d * m.d_ff_expert
                total += m.n_shared_experts * 3 * d * m.d_ff_expert
                if m.dense_residual:
                    total += 3 * d * (m.dense_residual_ff or m.d_ff_expert)
            else:
                mult = 3 if self.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU) else 2
                total += mult * d * f
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        dense = self.param_count() - self.n_layers * m.n_experts * 3 * d * m.d_ff_expert
        active_moe = self.n_layers * m.top_k * 3 * d * m.d_ff_expert
        return dense + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: StepKind

    @property
    def is_decode(self) -> bool:
        return self.kind == StepKind.DECODE


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. axis order is major-to-minor."""
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    def axis_size(self, name: str) -> int:
        if name not in self.axes:
            return 1
        return self.shape[self.axes.index(name)]

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes that carry pure data parallelism (batch + grad allreduce)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    zero1: bool = True              # shard optimizer state over data axis
    expert_parallel: bool = True    # shard MoE experts over model axis
    shard_vocab: bool = True        # shard embedding/head over model axis
    seq_shard_activations: bool = True   # Korthikanti-style SP regions
    remat: str = "block"            # none | block | full
    scan_layers: bool = True        # lax.scan over stacked layer params
    gradient_compression: bool = False  # int8 + error feedback DP allreduce
    # §Perf knobs (baselines keep these off)
    attn_probs_bf16: bool = False   # cast P to bf16 post-softmax
    moe_seq_dispatch: bool = False  # dedup EP dispatch over model axis
    attn_impl: str = "xla"          # xla | pallas (flash fwd+bwd kernels)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | linear | constant


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatch: int = 0             # 0 = no gradient accumulation
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    sharding: ShardingConfig = ShardingConfig()
    dropout: DropoutPlanConfig = DropoutPlanConfig()
    train: TrainConfig = TrainConfig()

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
