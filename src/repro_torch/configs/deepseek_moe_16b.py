"""DeepSeekMoE 16B — fine-grained 64-expert top-6 MoE with 2 shared experts.

[arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base]
28L d_model=2048 16H (MHA kv=16) d_ff=1408(per expert) vocab=102400.
First layer is dense (d_ff=10944); remaining 27 layers are MoE.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    act="silu",
    rope_theta=1e4,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared=2,
        d_shared=1408,
        first_dense_layers=1,
        dense_d_ff=10944,
    ),
    microbatch=2,
)
