"""Nemotron-4 340B — dense GQA decoder with squared-ReLU (non-gated) MLP.

[arXiv:2402.16819 (Nemotron-4 15B report describes the family); unverified]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="sq_relu",
    gated_mlp=False,
    rope_theta=1e4,
    microbatch=8,
    optimizer_m_dtype="bfloat16",
    activation_shard="embed",
    serve_fsdp=True,
)
