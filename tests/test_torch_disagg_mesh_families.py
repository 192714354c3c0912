"""Disaggregated serving over cells of several mesh positions, the moe
and encdec families (CPU, float32): the cold + warm + drain scenario of
``tests/test_torch_disagg_mesh.py`` (its ``check``; qwen3-4b runs it
there) over the 2-row layout, a prefill cell over (2, 2) feeding
replicas over (2, 1), against the JAX package's one-device server.  The
doomed replica's pages migrate and its slot is handed off, as JAX's
are; the smoke configs' four kv heads cross from split to whole.
deepseek-moe-16b's prompts stay short, so the MoE capacity a position
reckons from its own tokens drops nothing.  The ssm and hybrid families
are in ``tests/test_torch_disagg_mesh_snapshot.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from test_torch_disagg_mesh import check  # noqa: E402


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "seamless-m4t-large-v2"])
def test_paged_families_drain_over_two_rows(arch):
    tokens, c = check("drain", arch, "prefill-2x2-decode-2x1")
    assert len(tokens) == 7 and c["held"] == 1
    assert c["pages_migrated"] > 0 and c["routed_warm"] > 0
    assert c["sync"]["requeued"] == 0 and c["drain_handoffs"] == 1
