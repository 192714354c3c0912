"""The optimizer's configuration.

Only :class:`OptConfig` is here: a :class:`~repro_torch.core.spec.CellSpec`
and a :class:`~repro_torch.core.cell.Cell` carry one.  AdamW, its
schedules and the train step come with training (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # memory knobs for the big archs
    m_dtype: str = "float32"
    v_dtype: str = "float32"
