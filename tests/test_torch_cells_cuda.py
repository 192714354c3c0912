"""Cells on the card (marked ``cuda``; skipped without a GPU).

Two float32 qwen3-4b smoke serve cells on one card (a 1x1x4 grid over
``cuda``, the device repeated), the supervisor's verbs against the step
graphs of the cells' batchers:

* a resize (a column transferred) drops every graph of the cell's
  batchers and moves the epoch on; the graphs captured again after it
  replay bitwise equal to eager steps from the same state, and the
  guard passes;
* a graph kept from before the resize fails ``validate_cell_programs``;
* ``destroy`` frees the cell's graph pool and weights;
* ``send_pages`` of one request's interned pages arrives bitwise equal,
  with its bytes counted;
* a batcher its caller drops frees at least its arena (the cell holds
  its batchers weakly).

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_cells_cuda.py
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BoundaryViolation,
    CellSpec,
    ClusterSpec,
    DeviceGrid,
    Supervisor,
    tree_bytes,
)
from repro_torch.models.cache_utils import read_arena_pages  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.kvpool import request_ctx_key  # noqa: E402

PAGE = 8
KW = {"batch_slots": 2, "max_len": 64, "page_size": PAGE, "prefill_chunk": 8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    sysp = rng.randint(1, vocab, size=20)
    return [np.concatenate([sysp, rng.randint(1, vocab, size=n)])
            .astype(np.int32) for n in lens]


def _cluster(dev):
    cfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
    sup = Supervisor(DeviceGrid.from_flat([dev], 1, 1, 4, allow_reuse=True))
    spec = ClusterSpec(cells=(
        CellSpec("a", cfg, "serve", ncols=2, min_ncols=1, max_ncols=3),
        CellSpec("b", cfg, "serve", ncols=2, min_ncols=1, max_ncols=3)))
    sup.apply(spec)
    for i, name in enumerate("ab"):
        sup.cells[name].init_serve(
            generator=torch.Generator(device=dev).manual_seed(i))
    return sup, spec


def _submit(bat, vocab, lens=(3, 9), max_new=24):
    for i, p in enumerate(_prompts(vocab, list(lens))):
        bat.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))


def _state(bat):
    return tree_leaves(bat._decode_state()[1:])


@pytest.mark.cuda
def test_resize_drops_graphs_and_replays_equal_eager(dev):
    sup, spec = _cluster(dev)
    a = sup.cells["a"]
    graphed = a.make_batcher(**KW)
    eager = ContinuousBatcher(a.model, a.serve_params, device=dev, **KW)
    eager.step_graph = None
    for bat in (graphed, eager):
        _submit(bat, a.model.cfg.vocab)
    for _ in range(4):
        graphed.step()
        eager.step()
    torch.cuda.synchronize()
    before = graphed.step_graph.stats()["decode"]
    assert graphed.step_graph.captured()
    epoch = a.zone_epoch
    plan = sup.apply(spec.scale("a", 3).scale("b", 1))
    assert [op.verb for op in plan.ops] == ["transfer"]
    assert a.zone_epoch > epoch and graphed.step_graph.epoch == a.zone_epoch
    assert not graphed.step_graph.captured()
    assert graphed.step_graph.stats()["decode"]["dropped"] > \
        before["dropped"]
    for dst, src in zip(_state(eager), _state(graphed)):
        dst.copy_(src)                   # the same state from here on
    eager.pos[:], eager.cur_tok[:] = graphed.pos, graphed.cur_tok
    for _ in range(10):
        graphed.step()
        eager.step()
        assert [r.output for r in graphed.slot_req] == \
            [r.output for r in eager.slot_req]
    torch.cuda.synchronize()
    after = graphed.step_graph.stats()["decode"]
    assert after["captures"] > before["captures"]
    assert after["replays"] >= before["replays"] + 8
    assert all(e.epoch == a.zone_epoch
               for e in graphed.step_graph.captured().values())
    bitwise = all(torch.equal(x, y) for x, y in zip(_state(graphed),
                                                   _state(eager)))
    print(f"[cells] after the resize: {after}; state bitwise equal to "
          f"eager: {bitwise}")
    assert bitwise
    assert sup.validate_cell_programs("a") >= 3
    graphed.close()


@pytest.mark.cuda
def test_graph_kept_from_before_a_resize_is_stale(dev):
    sup, spec = _cluster(dev)
    a = sup.cells["a"]
    bat = a.make_batcher(**KW)
    _submit(bat, a.model.cfg.vocab, max_new=6)
    for _ in range(4):
        bat.step()
    kept = dict(bat.step_graph._entries)
    assert any(e.graph is not None for e in kept.values())
    assert sup.validate_cell_programs("a") >= 3
    sup.apply(spec.scale("a", 1).scale("b", 3))
    assert sup.validate_cell_programs("a") == 2     # weights + batcher
    bat.step_graph._entries.update(kept)
    with pytest.raises(BoundaryViolation, match="stale graph"):
        sup.validate_cell_programs("a")
    bat.close()


@pytest.mark.cuda
def test_destroy_frees_the_graph_pool_and_weights(dev):
    sup, spec = _cluster(dev)
    gc.collect()
    torch.cuda.synchronize()
    b = sup.cells["b"]
    weights = tree_bytes(b.serve_params)
    bat = b.make_batcher(**KW)
    _submit(bat, b.model.cfg.vocab, max_new=6)
    bat.run_until_drained()
    assert bat.step_graph.captured()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del bat, b
    sup.destroy_cell("b")
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    print(f"[cells] destroy freed {freed} bytes; weights {weights} bytes")
    assert freed >= weights
    assert "b" not in sup.cells and not sup.table.has_zone("b")


@pytest.mark.cuda
def test_send_pages_arrives_bitwise_equal(dev):
    sup, spec = _cluster(dev)
    a = sup.cells["a"]
    bat = a.make_batcher(**KW)
    _submit(bat, a.model.cfg.vocab, max_new=4)
    bat.run_until_drained()
    req = bat.done[0]
    pages = [n.page for n in bat.pool.tree.match(req.prompt,
                                                 request_ctx_key(req))]
    assert pages
    stacks = read_arena_pages(bat.pool.arena, pages)
    ch = sup.open_channel("a", "b", kind="pages")
    stats = ch.send_pages(stacks, meta={"rid": req.rid, "pages": pages})
    env = ch.poll_pages()
    torch.cuda.synchronize()
    assert env.meta == {"rid": req.rid, "pages": pages}
    for x, y in zip(tree_leaves(env.cache), tree_leaves(stacks)):
        assert x.device == y.device and torch.equal(x, y)
        assert x.data_ptr() != y.data_ptr()
    assert stats["bytes"] == ch.bytes_sent == tree_bytes(stacks) > 0
    rec = a.accounting.recorder
    assert [e["name"] for e in rec.log if e["name"].startswith("xfer")] == \
        ["xfer:pages"]
    bat.close()


@pytest.mark.cuda
def test_a_dropped_batcher_frees_its_arena(dev):
    sup, spec = _cluster(dev)
    a = sup.cells["a"]
    bat = a.make_batcher(**KW)
    keep = a.make_batcher(**KW)
    _submit(bat, a.model.cfg.vocab, max_new=6)
    bat.run_until_drained()
    assert bat.step_graph.captured()
    arena = sum(t.numel() * t.element_size()
                for t in tree_leaves(bat.pool.arena))
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    bat.close()
    del bat
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    print(f"[cells] dropping a batcher freed {freed} bytes; its arena "
          f"{arena} bytes")
    assert freed >= arena
    assert a.live_batchers() == [(1, keep)]
    assert sup.validate_cell_programs("a") == 2     # weights + keep
