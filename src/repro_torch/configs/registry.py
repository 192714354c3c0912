"""Registry of assigned architectures (``--arch <id>``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    mixtral_8x7b,
    deepseek_moe_16b,
    zamba2_2p7b,
    qwen3_4b,
    deepseek_coder_33b,
    qwen2p5_32b,
    nemotron4_340b,
    mamba2_2p7b,
    seamless_m4t_large_v2,
    chameleon_34b,
)

_ARCHS = (
    mixtral_8x7b.CONFIG,
    deepseek_moe_16b.CONFIG,
    zamba2_2p7b.CONFIG,
    qwen3_4b.CONFIG,
    deepseek_coder_33b.CONFIG,
    qwen2p5_32b.CONFIG,
    nemotron4_340b.CONFIG,
    mamba2_2p7b.CONFIG,
    seamless_m4t_large_v2.CONFIG,
    chameleon_34b.CONFIG,
)

ARCHS: Dict[str, ArchConfig] = {a.name: a for a in _ARCHS}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
