"""Disaggregated serving over cells of several mesh positions, the ssm
and hybrid families on the snapshot plane (CPU, float32): the cold +
warm + drain scenario of ``tests/test_torch_disagg_mesh.py`` (its
``check``) over the 2-row layout, a prefill cell over (2, 2) feeding
replicas over (2, 1), against the JAX package's one-device server.  The
handoffs carry the Mamba state laid out by position (the conv state's
[x_r | B | C] segments) through its logical tensor; the doomed
replica's interned chains migrate and its slot requeues, as JAX's do.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from test_torch_disagg_mesh import check  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_snapshot_families_drain_over_two_rows(arch):
    tokens, c = check("drain", arch, "prefill-2x2-decode-2x1")
    assert len(tokens) == 7 and c["held"] == 1
    assert c["pages_migrated"] > 0 and c["routed_warm"] > 0
    assert c["sync"]["requeued"] == 1 and c["drain_handoffs"] == 0
