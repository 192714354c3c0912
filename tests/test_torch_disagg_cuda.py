"""Disaggregated installs on the card (marked ``cuda``; skipped without a
GPU).

A decode replica's step graphs replay on the addresses they captured, so
every install must write in place.  Two float32 qwen3-4b smoke replicas
on one card, one stepping through its CUDA graphs and one eagerly, take
the same requests: KV from a prefill worker (``install_paged``) and, once
the graphed replica's decode graph is captured, another request the same
way and a request migrated mid-decode from a third batcher
(``export_slot`` then ``adopt_slot``).  Every later step of the graphed
replica replays (``check_unmoved`` would raise on a moved tensor) and
gives the eager replica's tokens and state, bitwise.

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_disagg_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import DeviceGrid, Supervisor  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.disagg import PrefillWorker  # noqa: E402
from repro_torch.serve.kvpool import request_ctx_key  # noqa: E402

PAGE = 8
KW = {"batch_slots": 3, "max_len": 64, "page_size": PAGE,
      "prefill_chunk": None}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _state(bat):
    return tree_leaves(bat._decode_state()[1:])


def _install(worker, bats, req_of):
    """Prefill one request on the worker and install its payload into
    each batcher (``req_of(i)``: batcher i's copy of the request)."""
    tok, payload = worker.prefill(req_of(0))
    for i, bat in enumerate(bats):
        req = req_of(i)
        lease = bat.pool.lease(req.prompt, request_ctx_key(req))
        assert bat.install_paged(req, payload["stacks"], payload["resident"],
                                 0, tok, lease)


@pytest.mark.cuda
def test_installs_into_a_captured_replica_replay_equal_eager(dev):
    cfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
    sup = Supervisor(DeviceGrid.from_flat([dev], 1, 1, 2, allow_reuse=True))
    pre = sup.create_cell("prefill", cfg, "serve", ncols=1)
    dec = sup.create_cell("decode", cfg, "serve", ncols=1)
    dec.init_serve(generator=torch.Generator(device=dev).manual_seed(0))
    pre.init_serve(params=dec.serve_params)
    worker = PrefillWorker(pre, max_len=KW["max_len"], chunk=8,
                           page_size=PAGE)
    graphed = dec.make_batcher(**KW)
    eager = ContinuousBatcher(dec.model, dec.serve_params, device=dev, **KW)
    eager.step_graph = None
    source = ContinuousBatcher(dec.model, dec.serve_params, device=dev, **KW)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32)
               for n in (13, 22, 17)]
    reqs = {}

    def req_of(rid):
        return lambda i: reqs.setdefault((rid, i), Request(
            rid=rid, prompt=prompts[rid], max_new_tokens=24))

    _install(worker, [graphed, eager], req_of(0))
    for _ in range(6):
        graphed.step()
        eager.step()
    torch.cuda.synchronize()
    before = graphed.step_graph.stats()["decode"]
    assert graphed.step_graph.captured() and before["replays"] > 0
    # a request prefilled elsewhere, and one migrated mid-decode
    _install(worker, [graphed, eager], req_of(1))
    _install(worker, [source], req_of(2))
    for _ in range(3):
        source.step()
    snap = source.export_slot(0)
    for i, bat in enumerate((graphed, eager)):
        moved = Request(rid=2, prompt=prompts[2], max_new_tokens=24,
                        output=list(snap["req"].output))
        assert bat.adopt_slot(moved, snap["stacks"], snap["resident"],
                              snap["pos"], snap["cur_tok"])
    source.drop_slot(0)
    for _ in range(12):
        graphed.step()
        eager.step()
        assert [r.output if r else None for r in graphed.slot_req] == \
            [r.output if r else None for r in eager.slot_req]
    torch.cuda.synchronize()
    after = graphed.step_graph.stats()["decode"]
    bitwise = all(torch.equal(x, y) for x, y in zip(_state(graphed),
                                                   _state(eager)))
    print(f"[disagg] decode graphs before the installs {before}, after "
          f"{after}; state bitwise equal to eager: {bitwise}")
    assert after["replays"] >= before["replays"] + 12
    assert after["eager_calls"] == before["eager_calls"]
    assert bitwise
    graphed.close()
    worker.close()
