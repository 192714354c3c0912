"""The port's disaggregated server against the JAX package's for the
other families (CPU, float32): mamba2-2.7b and zamba2-2.7b on the
snapshot plane, seamless-m4t-large-v2 on the paged plane with ragged
sources, the daemon ticking; tokens and counters as
``tests/test_torch_disagg.py`` holds them (its ``Side`` and ``both``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from test_torch_disagg import MAX_LEN, both, counters, drained  # noqa: E402


@pytest.mark.parametrize(
    "arch", ["mamba2-2.7b", "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_disagg_all_families(arch):
    """ssm and hybrid on the snapshot plane, encdec on the paged plane with
    ragged sources: the whole disaggregated path, the daemon ticking."""
    def run(side):
        sup = side.supervisor(3)
        spec = side.spec(2)
        sup.apply(spec)
        side.init(sup.cells["decode/0"])
        srv = side.disagg.DisaggServer(sup, "prefill",
                                       spec.cell("decode").instances(),
                                       batch_slots=2, max_len=MAX_LEN,
                                       chunk=16)
        daemon = side.core.SupervisorDaemon(sup)
        daemon.attach_server(srv)
        for r in side.requests([3, 33, 17, 40, 9], max_new=4,
                               srcs=side.cfg.family == "encdec"):
            srv.submit(r)
        got = drained(srv, max_steps=2_000, on_step=daemon.tick)
        c = counters(side, sup, srv)
        c["chunked"] = srv.stats()["prefill_chunked"]
        return got, c

    got, c = both(run, arch=arch)
    assert len(got) == 5 and c["chunked"] and c["fallback"] == 0
    assert c["invocations"] > 0 and c["kv_transfers"] == 5
