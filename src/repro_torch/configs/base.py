"""Architecture + shape configuration system.

Every assigned architecture is expressed as an :class:`ArchConfig`; every
workload shape as a :class:`ShapeConfig`.  ``(arch, shape)`` pairs are the
dry-run / roofline cells.  Configs are frozen dataclasses so they can be used
as cache keys for compiled programs inside a Cell.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    d_expert: int                 # hidden width of each routed expert
    num_shared: int = 0           # DeepSeekMoE shared experts
    d_shared: int = 0             # hidden width of EACH shared expert
    capacity_factor: float = 1.25
    first_dense_layers: int = 0   # leading dense layers (DeepSeekMoE: 1)
    dense_d_ff: int = 0           # ffn width of those dense layers
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    ngroups: int = 1
    chunk: int = 256              # SSD chunk length (MXU-friendly)


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture. Field values come from public literature."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int               # decoder layers for encdec
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                     # dense ffn hidden (0 for pure SSM)
    vocab: int
    head_dim: Optional[int] = None
    act: str = "silu"             # silu | gelu | sq_relu
    gated_mlp: bool = True        # SwiGLU-style vs plain 2-matrix MLP
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    rms_eps: float = 1.0e-5
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None     # Mixtral SWA
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a weight-shared attention block every k SSM layers
    hybrid_attn_every: int = 0
    # encoder-decoder (seamless): encoder layer count; source side is a
    # precomputed-embedding stub (audio frontend) when True
    encoder_layers: int = 0
    source_is_embeddings: bool = False
    source_len_ratio: float = 1.0   # S_src = S * ratio for encdec shapes
    dtype: str = "bfloat16"
    # training memory knobs (tuned per arch in its config file)
    remat_policy: str = "nothing_saveable"
    microbatch: int = 1           # gradient-accumulation microbatches
    # residual-stream sharding between layers (Megatron-SP style):
    #   None = replicate non-batch dims; "seq" = shard seq over model axis;
    #   "embed" = shard d_model over model axis
    activation_shard: Optional[str] = "seq"
    # Adam first-moment dtype (bf16 halves optimizer HBM for the 340B)
    optimizer_m_dtype: str = "float32"
    # attention tiling (chunked-jnp path); unroll_attn trades HLO size for
    # loop-trip-count-visible cost_analysis (the roofline accounting mode)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    unroll_attn: bool = False
    # vocab padding multiple — mesh-INDEPENDENT so a resize never changes
    # parameter shapes (2048 = 128 lanes x the 16-wide production model axis)
    vocab_pad_multiple: int = 2048
    # beyond-paper perf knobs (hillclimb switches; default = paper-faithful)
    use_flash_kernel: bool = False
    decode_kv_shard_seq: bool = True   # shard KV cache seq dim over model axis
    # manual shard_map decode attention with distributed LSE combine —
    # replaces XLA's per-layer KV all-gather with a tiny stats psum
    sharded_decode: bool = False
    fsdp_params: bool = True           # shard weights over data axis too
    # serving cells: keep weights TP-sharded only (no per-step FSDP
    # gather).  Must stay True for archs whose weights don't fit a single
    # model-axis shard (nemotron-340b: 42 GB/chip without FSDP).
    serve_fsdp: bool = False
    # training layout: "tp" = Megatron TP+FSDP (paper-faithful baseline);
    # "zero3" = DP over every axis + vocab-parallel head — wins when
    # per-layer TP activation collectives dwarf weight traffic (small
    # dense archs).  MoE/encdec need the model axis and must stay "tp".
    train_layout: str = "tp"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads <= 0:          # attention-free (SSM) archs
            return 0
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic_decode(self) -> bool:
        """True if decode cost does not grow quadratically with context.

        SSM: O(1) state.  Hybrid: SSM + a couple of shared attention blocks.
        SWA: rolling KV buffer bounded by the window.
        """
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One workload shape (the paper pool's shape set for LM transformers)."""

    name: str
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def with_opt_level(arch: ArchConfig, optimized: bool) -> ArchConfig:
    """Paper-faithful baseline vs beyond-paper optimized flags.

    baseline : Megatron TP+FSDP everywhere, pjit-auto decode.
    optimized: per-arch train layout (zero3 where it wins), manual
               sharded decode (LSE combine), no serve-time FSDP gathers
               where the weights fit.
    """
    if optimized:
        return arch.replace(sharded_decode=True)
    return arch.replace(train_layout="tp", sharded_decode=False, serve_fsdp=True)


def shapes_for(arch: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The runnable shape set for an arch (long_500k only if sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.subquadratic_decode:
        out.append(LONG_500K)
    return tuple(out)


def smoke_config(arch: ArchConfig) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests.

    Keeps every structural feature (GQA ratio, MoE routing, SSD heads,
    hybrid interleave, enc-dec split) while shrinking widths/depths.
    """
    kw = dict(
        num_layers=max(2, min(4, arch.num_layers)),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, 4 * arch.num_kv_heads // max(arch.num_heads, 1)) or 1,
        head_dim=32,
        d_ff=256 if arch.d_ff else 0,
        vocab=512,
        vocab_pad_multiple=128,
        microbatch=1,
        sliding_window=64 if arch.sliding_window else None,
    )
    if arch.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=min(8, arch.moe.num_experts),
            top_k=min(2, arch.moe.top_k),
            d_expert=64,
            num_shared=min(1, arch.moe.num_shared),
            d_shared=64 if arch.moe.num_shared else 0,
            capacity_factor=arch.moe.capacity_factor,
            first_dense_layers=min(1, arch.moe.first_dense_layers),
            dense_d_ff=128 if arch.moe.first_dense_layers else 0,
        )
    if arch.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32)
    if arch.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
        kw["num_layers"] = 4
    if arch.encoder_layers:
        kw["encoder_layers"] = 2
    return arch.replace(name=arch.name + "-smoke", **kw)
