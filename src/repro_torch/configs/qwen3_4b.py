"""Qwen3 4B — dense GQA decoder with qk-norm.

[hf Qwen/Qwen3-4B (family config per pool: Qwen/Qwen3-8B)]
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    microbatch=2,
    train_layout="zero3",
)
