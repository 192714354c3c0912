"""DeepSeek-Coder 33B — llama-arch dense GQA decoder.

[arXiv:2401.14196; hf deepseek-ai/deepseek-coder-33b-base]
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    act="silu",
    rope_theta=1e5,
    microbatch=8,
    activation_shard="embed",
)
