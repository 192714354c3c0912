"""SeamlessM4T-Large v2 — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf facebook/seamless-m4t-v2-large]
24L d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206, enc-dec.
Backbone only per task spec: the audio frontend is a stub; input_specs()
provides precomputed frame embeddings for the encoder (24L) and token ids for
the decoder (24L, causal self-attn + cross-attn).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    act="gelu",
    gated_mlp=False,
    source_is_embeddings=True,
    source_len_ratio=1.0,
    microbatch=1,
)
