"""Chameleon 34B — early-fusion VLM decoder over a mixed text+VQ-image vocab.

[arXiv:2405.09818; unverified]
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, qk-norm.
Early fusion: VQ image tokens share the 65536 vocabulary with text tokens, so
the backbone consumes one mixed token stream (the VQ tokenizer frontend is a
stub per task spec).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    act="silu",
    qk_norm=True,
    rope_theta=1e4,
    microbatch=4,
)
