"""Qwen2.5 32B — dense GQA decoder with QKV bias.

[hf Qwen/Qwen2.5-32B (family config per pool: Qwen/Qwen2.5-0.5B)]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, qkv_bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    act="silu",
    qkv_bias=True,
    rope_theta=1e6,
    microbatch=4,
    activation_shard="embed",
)
