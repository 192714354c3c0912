"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window GQA attention.

[arXiv:2401.04088; hf mistralai/Mixtral-8x7B-v0.1]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA 4096.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    act="silu",
    rope_theta=1e6,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336),
    microbatch=2,
    activation_shard="embed",
)
