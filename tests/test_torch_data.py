"""The port's data pipeline (CPU): twins of ``tests/test_data.py``, and
batches bit for bit equal to the JAX pipeline's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro_torch.configs.base import ShapeConfig, smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402


def _pipe(arch, seq, batch, **kw):
    return SyntheticPipeline(DataConfig(**kw), smoke_config(get_arch(arch)),
                             ShapeConfig("t", "train", seq, batch),
                             device="cpu")


def test_deterministic_batches():
    a = _pipe("qwen3-4b", 16, 4, kind="bigram", seed=7)
    b = _pipe("qwen3-4b", 16, 4, kind="bigram", seed=7)
    ba, bb = a.get_batch(13), b.get_batch(13)
    assert torch.equal(ba["tokens"], bb["tokens"])
    assert not torch.equal(a.get_batch(14)["tokens"], ba["tokens"])


def test_labels_are_next_tokens():
    b = _pipe("qwen3-4b", 32, 2, kind="bigram").get_batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32


def test_bigram_entropy_floor_reasonable():
    h = _pipe("qwen3-4b", 8, 2, kind="bigram", branching=8).bigram_entropy()
    assert 0.5 < h < np.log(8) + 1e-6


def test_encdec_src_embeddings():
    cfg = smoke_config(get_arch("seamless-m4t-large-v2"))
    b = _pipe("seamless-m4t-large-v2", 16, 2, kind="bigram").get_batch(0)
    assert b["src"].shape == (2, 16, cfg.d_model)
    assert b["src"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "bigram"),
                                       ("qwen3-4b", "uniform"),
                                       ("seamless-m4t-large-v2", "bigram")])
def test_batches_equal_jax_bit_for_bit(arch, kind):
    jp = JPipeline(JDataConfig(kind=kind, seed=11),
                   j_smoke_config(j_get_arch(arch)),
                   JShape("t", "train", 24, 3))
    tp = _pipe(arch, 24, 3, kind=kind, seed=11)
    if kind == "bigram":
        assert tp.bigram_entropy() == jp.bigram_entropy()
    for step in (0, 5):
        jb, tb = jp.get_batch(step), tp.get_batch(step)
        assert set(jb) == set(tb)
        for k in jb:
            a = np.asarray(jnp.asarray(jb[k], jnp.float32)
                           if k == "src" else jb[k])
            b = tb[k].float().numpy() if k == "src" else tb[k].numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), k
