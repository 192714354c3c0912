"""Zamba2 2.7B — Mamba-2 backbone with weight-shared attention blocks.

[arXiv:2411.15242; hf Zyphra/Zamba2-2.7B]
54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
A single weight-shared transformer block (attn+MLP) is applied every 6 SSM
layers on concat(x, x0) (the Zamba concat trick), projected back to d_model.
Simplification vs HF: one shared block (not two alternating) and no per-call
LoRA deltas; noted in DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="gelu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_attn_every=6,
    microbatch=2,
)
