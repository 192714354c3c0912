"""Mamba-2 2.7B — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified]
64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 5120, head_dim=64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=None,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    microbatch=2,
    train_layout="zero3",
)
