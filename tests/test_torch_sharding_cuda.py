"""Serve cells over several mesh positions on the card (marked ``cuda``;
skipped without a GPU).

* A float32 smoke serve cell over two positions of one card (qwen3-4b;
  deepseek-moe-16b with its experts over ``model``; mamba2-2.7b and
  zamba2-2.7b on the snapshot pool, their Mamba layers over SSD heads;
  seamless-m4t-large-v2 with ragged sources and requests without one)
  gives a one-position cell's greedy tokens; its steps are captured as
  CUDA graphs over both positions and replayed, and the guard passes.
* The same over (data 2, model 2): two rows of two positions of one
  card, four slots, the batch split over ``data`` and the paged arena
  whole on both data rows (its writes mirrored): the one-position cell's
  tokens, one graph a key over the four positions, and every data row's
  copy of the arena bitwise the same after the drain.
* The collectives over positions of one card: every position of a
  ``psum`` holds the same bits, the float32 sum in position order.
* The model-level decode over a dense cache split on its sequence dim
  between two positions of one card, ``sharded_decode`` on and off,
  gives the one-position model's logits (float32).
* With two (four) cards or more, a cell over positions on two (four)
  distinct cards gives the same tokens, its steps eager (one graph
  cannot span cards); with two, disaggregated serving between two such
  cells gives one card's tokens.
* A float32 smoke train cell of each family over (data 2, model 2) of
  one card, and with two (four) cards over (1, 2) ((2, 2)) of distinct
  cards, gives a one-position cell's losses and grad norms (1e-5
  relative) and its params after 2 steps (1e-5, leaf by leaf as
  ||a - b|| / ||b||), every backward on the CUDA-core route.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharding_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CellSpec,
    ClusterSpec,
    DeviceGrid,
    Supervisor,
)
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    params_from_numpy,
    shard_tree,
    tree_map,
)
from repro_torch.serve.batcher import Request  # noqa: E402
from repro_torch.sharding.collectives import psum  # noqa: E402
from repro_torch.sharding.rules import make_ctx  # noqa: E402
from repro_torch.sharding.sharded import Sharded  # noqa: E402

KW = {"batch_slots": 2, "max_len": 64, "page_size": 8, "prefill_chunk": 8}
ARCHS = ["qwen3-4b", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-2.7b",
         "seamless-m4t-large-v2"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _serve(arch, grid, ncols, seed=0, **kw):
    """Two waves behind a shared prefix through a serve cell (``kw``
    over the batcher's ``KW``): ({rid: tokens}, the cell, its
    batcher)."""
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    model = Model(cfg)
    host = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(seed), device="cpu"))
    sup = Supervisor(grid)
    sup.apply(ClusterSpec(cells=(CellSpec("c", cfg, "serve",
                                          ncols=ncols),)))
    cell = sup.cells["c"]
    cell.init_serve(params=params_from_numpy(
        host, dtype=torch.float32, device=grid.devices.flat[0],
        specs=model.param_specs()))
    bat = cell.make_batcher(**{**KW, **kw})
    rng = np.random.default_rng(4)
    shared = rng.integers(1, cfg.vocab, size=20).astype(np.int32)
    rid = 0
    for _ in range(2):
        for lens in ([3, 9, 5], [6, 2]):
            for n in lens:
                # encdec: ragged sources, every other request without one
                src = (rng.standard_normal((4 * n, cfg.d_model)).astype(
                    np.float32) if cfg.family == "encdec" and n % 2 else None)
                bat.submit(Request(rid=rid, prompt=np.concatenate(
                    [shared, rng.integers(1, cfg.vocab, size=n).astype(
                        np.int32)]), max_new_tokens=6, src=src))
                rid += 1
            bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}, sup, bat


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_two_positions_of_one_card_give_one_position_tokens(dev, arch):
    one, _, b1 = _serve(arch, DeviceGrid.from_flat([dev], 1, 1, 2,
                                                   allow_reuse=True), 2)
    two, sup, bat = _serve(arch, DeviceGrid.from_flat([dev, dev], 1, 1, 2),
                           2)
    assert sup.cells["c"].mesh.size == 2 and b1.model.ctx is None
    assert two == one
    g = bat.step_graph.stats()
    assert bat.step_graph.capture and g["decode"]["replays"] > 0
    assert sup.validate_cell_programs("c") >= 2
    b1.close()
    bat.close()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_two_rows_of_one_card_give_one_position_tokens(dev, arch):
    one, _, b1 = _serve(arch, DeviceGrid.from_flat([dev], 1, 1, 2,
                                                   allow_reuse=True), 2,
                        batch_slots=4)
    rows, sup, bat = _serve(arch, DeviceGrid.from_flat([dev] * 4, 1, 2, 2),
                            2, batch_slots=4)
    cell = sup.cells["c"]
    assert cell.mesh.shape == {"data": 2, "model": 2}
    assert rows == one
    g = bat.step_graph.stats()
    assert bat.step_graph.capture and g["decode"]["replays"] > 0
    assert sup.validate_cell_programs("c") >= 2
    for node in (bat.pool.arena if bat._paged else []):
        for leaf in node:
            for grp in cell.mesh.groups(("data",)):
                assert all(torch.equal(leaf.shards[grp[0]], leaf.shards[r])
                           for r in grp[1:])
    b1.close()
    bat.close()


@pytest.mark.cuda
def test_psum_over_positions_of_one_card(dev):
    mesh = make_mesh_for_devices(1, 4, devices=[dev])
    g = torch.Generator(device=dev).manual_seed(0)
    x = Sharded([torch.randn(64, 128, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4)], mesh)
    y = psum(x, "model")
    want = x.shards[0].float()
    for s in x.shards[1:]:
        want = want + s.float()
    for s in y.shards:
        assert torch.equal(s, want.to(torch.bfloat16))
    assert len({s.data_ptr() for s in y.shards}) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_cards", [2, 4])
def test_positions_on_distinct_cards_run_eagerly(dev, arch, n_cards):
    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} cards")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    one, _, b1 = _serve(arch, DeviceGrid.from_flat(
        cards[:1], 1, 1, n_cards, allow_reuse=True), n_cards)
    many, sup, bat = _serve(arch, DeviceGrid.from_flat(
        cards, 1, 1, n_cards), n_cards)
    assert sup.cells["c"].mesh.size == n_cards
    assert many == one
    assert not bat.step_graph.capture
    assert all(v["captures"] == 0 for v in bat.step_graph.stats().values())
    assert {t.device for t in bat.state_tensors()} == set(cards)
    b1.close()
    bat.close()


@pytest.mark.cuda
def test_disaggregated_serving_over_distinct_cards(dev):
    """A prefill cell and a decode cell, each over two positions on two
    distinct cards (smoke qwen3-4b with four kv heads, split over
    ``model``): the weights fan out and the KV crosses into the
    replica's layout card by card, and the tokens are those of
    one-position cells on one card."""
    from repro_torch.serve.disagg import DisaggServer
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards")
    cfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32",
                                                     num_kv_heads=4)
    model = Model(cfg)
    host = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(1)
    shared = rng.integers(1, cfg.vocab, size=20).astype(np.int32)
    waves = [[np.concatenate([shared, rng.integers(
        1, cfg.vocab, size=n).astype(np.int32)]) for n in lens]
        for lens in ([3, 9, 5], [6, 2])]
    cards = [torch.device("cuda", i) for i in range(2)]

    def run(grid, ncols):
        sup = Supervisor(grid)
        sup.create_cell("prefill", cfg, "serve", ncols=ncols)
        dec = sup.create_cell("decode", cfg, "serve", ncols=ncols)
        dec.init_serve(params=params_from_numpy(
            host, dtype=torch.float32, device=str(dec.device),
            specs=model.param_specs()))
        srv = DisaggServer(sup, "prefill", "decode", batch_slots=2,
                           max_len=64, page_size=8, chunk=8)
        rid = 0
        for wave in waves:
            for p in wave:
                srv.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
                rid += 1
            srv.run_until_drained()
        out = {r.rid: r.output for r in srv.done}
        srv.close()
        return out, sup

    one, _ = run(DeviceGrid.from_flat(cards[:1], 1, 1, 4,
                                      allow_reuse=True), 1)
    many, sup = run(DeviceGrid.from_flat(cards * 2, 1, 1, 4), 2)
    assert set(sup.cells["prefill"].mesh.positions) == set(cards)
    assert set(sup.cells["decode"].mesh.positions) == set(cards)
    assert many == one and len(many) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("sharded_decode", [False, True],
                         ids=["gathered", "lse"])
def test_decode_over_a_sequence_split_cache(dev, sharded_decode):
    """float32 smoke qwen3-4b at (data 1, model 2) on one card, its dense
    cache split on its sequence dim: the prefill and four decode steps
    give the one-position model's logits within 1e-5; the gather path
    launches the dense decode kernel per position, the LSE path never."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    cfg = smoke_config(get_arch("qwen3-4b")).replace(
        num_layers=2, dtype="float32", sharded_decode=sharded_decode)
    one = Model(cfg)
    p1 = one.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    ctx = make_ctx(make_mesh_for_devices(1, 2, devices=[dev]))
    two = build_model(cfg, ctx)
    p2 = shard_tree(p1, two.params_pspecs(), ctx)
    B, S, n = 4, 64, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    c1 = one.init_cache(B, S, device=dev)
    c2 = two.init_cache(B, S, device=dev, pspecs=two.cache_pspecs(B, S))
    assert "model" in c2["layers"].k.spec.axes_of(2)
    with torch.no_grad():
        _, c1 = one.prefill(p1, {"tokens": toks[:, :S - n]}, c1)
        _, c2 = two.prefill(p2, {"tokens": toks[:, :S - n]}, c2)
        decode_attention.launches = 0
        for p in range(S - n, S):
            batch = {"tokens": toks[:, p:p + 1], "pos": torch.full(
                (B,), p, dtype=torch.int32, device=dev)}
            l1, c1 = one.decode(p1, c1, batch)
            before = decode_attention.launches
            l2, c2 = two.decode(p2, c2, batch)
            want = 0 if sharded_decode else 2 * cfg.num_layers
            assert decode_attention.launches - before == want
            err = (l2 - l1).abs().max() / l1.abs().max()
            assert float(err) < 1e-5


def _train(arch, grid, ncols, steps=2):
    """Float32 smoke train steps of ``arch`` (a MoE dropless) through a
    train cell over ``grid``'s ``ncols`` columns, from the same weights
    (drawn on the CPU) and batches: ([(loss, grad norm)], the params
    after the steps on the CPU)."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.resharding import reshard_tree
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.param import gather_tree, jax_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    sup = Supervisor(grid)
    cell = sup.create_cell("t", cfg, "train", ncols=ncols,
                           opt_cfg=OptConfig())
    full = init_train_state(Model(cfg), torch.Generator().manual_seed(0),
                            OptConfig())
    cell.state, _ = (cell._relay(full) if cell.ctx is not None
                     else reshard_tree(full, cell.device))
    dev0 = grid.devices.flat[0]
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg,
                             ShapeConfig("t", "train", 32, 4), device=dev0)
    mets = [cell.train_steps(pipe.get_batch, 1) for _ in range(steps)]
    params = [t.float().cpu() for t in
              jax_leaves(gather_tree(cell.state.params))]
    return [(m["loss_step"], m["grad_norm"]) for m in mets], params


def _close(got, want):
    (m1, p1), (m2, p2) = got, want
    for x, y in zip(m1, m2):
        for a, b in zip(x, y):
            assert abs(a - b) <= 1e-5 * abs(b), (m1, m2)
    for a, b in zip(p1, p2):
        assert float(torch.linalg.vector_norm(a - b)) <= \
            1e-5 * float(torch.linalg.vector_norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_train_over_positions_of_one_card_gives_one_position_steps(dev,
                                                                    arch):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    one = _train(arch, DeviceGrid.from_flat([dev], 1, 1, 1), 1)
    before = flash_attention_bwd.launches_tc
    four = _train(arch, DeviceGrid.from_flat([dev] * 4, 1, 2, 2), 2)
    assert flash_attention_bwd.launches_tc == before
    _close(four, one)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_cards", [2, 4])
def test_train_on_distinct_cards_gives_one_position_steps(dev, arch,
                                                          n_cards):
    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} cards")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    one = _train(arch, DeviceGrid.from_flat(cards[:1], 1, 1, 1), 1)
    rows = 2 if n_cards == 4 else 1
    many = _train(arch, DeviceGrid.from_flat(cards, 1, rows,
                                             n_cards // rows), n_cards // rows)
    _close(many, one)

