"""The port's supervisor, cells, guard and channels (CPU).

* ``python -m repro_torch.launch.serve --device cpu`` serves through
  ``Supervisor.apply`` -> ``Cell.init_serve`` -> ``Cell.make_batcher``,
  and its float32 greedy tokens equal those of ``python -m
  repro.launch.serve`` on the same weights (JAX's ``Model.init(PRNGKey(0))``
  through ``params_from_numpy``).
* On a 1x1x4 grid with one device reused, create, resize, transfer,
  ``spawn_child``, ``fail_column``, recover, ``restore_column``,
  ``mitigate_straggler`` and destroy (imperative and through
  ``apply``/``reconcile``) give the same events, zones and epochs as the
  JAX supervisor on the matching grid (times aside).
* A cell's batcher gives the same tokens across a resize as a batcher
  that was never resized; the guard refuses a cell tensor off the zone's
  device and a graph record from an older epoch.
* A cell holds its batchers weakly, as JAX's holds none: one its caller
  drops is collected with its arena, while a live one keeps its number in
  the guard's programs and still loses its graphs on a resize.
* ``ArrayChannel`` and ``ControlPlane`` round-trip as in
  ``tests/test_core.py``.
* A train cell killed by ``fail_column`` and recovered from its
  ``ckpt_dir`` (imperatively, and by the reconciler from the spec's
  ``ckpt_dir``) trains on with the uninterrupted run's losses, bit for
  bit; a resize mid-run changes nothing either; the recover's events are
  JAX's.  A serve cell restores its params; a directory without a
  checkpoint logs ``recover_no_ckpt`` and brings the cell back empty.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

import repro.core.cell as j_cell_mod  # noqa: E402
import repro.launch.serve as j_serve  # noqa: E402
import repro_torch.core.cell as t_cell_mod  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
from repro.configs.base import smoke_config, with_opt_level  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.core import DeviceGrid as JGrid  # noqa: E402
from repro.core import Supervisor as JSupervisor  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BoundaryViolation,
    CellError,
    CellSpec,
    ChannelError,
    ClusterSpec,
    ControlPlane,
    DeviceGrid,
    KVEnvelope,
    Supervisor,
    single_device_grid,
)
from repro_torch.core import spec as t_spec  # noqa: E402
from repro_torch.core.guard import Program  # noqa: E402
from repro_torch.models.param import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402

_CACHE = {}


def _jax_params(jcfg):
    """JAX's Model.init(PRNGKey(0)) of ``jcfg`` as float32 CPU tensors."""
    key = repr(jcfg)
    if key not in _CACHE:
        jp = build_model(jcfg, single_device_ctx()).init(jax.random.PRNGKey(0))
        _CACHE[key] = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=torch.float32, device="cpu")
    return _CACHE[key]


def _f32(smoke):
    return lambda arch: smoke(arch).replace(dtype="float32")


# ---------------------------------------------------------------------------
# launch.serve through the supervisor == the JAX entry
# ---------------------------------------------------------------------------
def _capture(monkeypatch, mod):
    """Record the cells and batchers ``mod``'s Cell.make_batcher makes."""
    made = []
    orig = mod.Cell.make_batcher

    def make_batcher(self, **kw):
        bat = orig(self, **kw)
        made.append((self, bat))
        return bat

    monkeypatch.setattr(mod.Cell, "make_batcher", make_batcher)
    return made


def test_launch_serve_goes_through_a_cell_and_matches_jax(monkeypatch,
                                                          capsys):
    argv = ["--requests", "4", "--max-new", "4", "--max-len", "64"]
    monkeypatch.setattr(j_serve, "smoke_config", _f32(smoke_config))
    monkeypatch.setattr(t_serve, "smoke_config", _f32(t_smoke_config))
    j_made = _capture(monkeypatch, j_cell_mod)
    t_made = _capture(monkeypatch, t_cell_mod)
    jcfg = with_opt_level(_f32(smoke_config)(get_arch("qwen3-4b")), True)
    weights = _jax_params(jcfg)
    orig_init = t_cell_mod.Cell.init_serve
    inits = []

    def init_serve(self, params=None, generator=None):
        inits.append(generator)
        return orig_init(self, params=weights)

    monkeypatch.setattr(t_cell_mod.Cell, "init_serve", init_serve)
    assert j_serve.main(argv) == 0
    assert t_serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "supervisor events" in out and '"op": "create"' in out
    (jcell, jbat), = j_made
    (tcell, tbat), = t_made
    assert len(inits) == 1 and inits[0] is not None   # seeded by the entry
    assert tbat.accounting is tcell.accounting
    assert tcell.status == "running" and tcell.live_batchers() == [(0, tbat)]
    assert len(tcell.accounting.requests) == 4
    assert tcell.accounting.recorder.open_spans == []
    tout = {r.rid: r.output for r in tbat.done}
    jout = {r.rid: r.output for r in jbat.done}
    assert sorted(tout) == [0, 1, 2, 3]
    assert tout == jout


# ---------------------------------------------------------------------------
# lifecycle events and zones == the JAX supervisor's
# ---------------------------------------------------------------------------
TIMES = {"ts", "seconds", "seconds_total", "gbps", "resize_seconds"}


def _events(sup):
    return [{k: v for k, v in e.items() if k not in TIMES}
            for e in sup.events]


def _zones(sup):
    t = sup.table
    return (t.epoch, [(z.name, z.pods, z.c0, z.c1) for z in t.zones],
            sorted(t.failed_columns),
            {n: (c.status, c.zone.ncols, c.parent)
             for n, c in sorted(sup.cells.items())})


def _lifecycle(sup, cfg, spec_mod):
    seen = []
    a = sup.create_cell("a", cfg, "serve", ncols=2)
    sup.create_cell("b", cfg, "train", ncols=1)
    seen.append(_zones(sup))
    seen.append(sorted(sup.resize_cell("b", 2)))
    seen.append(_zones(sup))
    out = sup.transfer_columns("b", "a", 1)
    seen.append((sorted(out), out["shrink"]["new"], out["grow"]["new"]))
    seen.append(_zones(sup))
    sup.spawn_child("a", "c", cfg, "serve", ncols=1)
    seen.append((sup.lineage("c"), _zones(sup)))
    affected = sup.fail_column(0, sup.cells["b"].zone.c0)
    seen.append((affected, _zones(sup)))
    sup.destroy_cell("c")
    sup.recover_cell("b", ncols=2)               # degrades to what fits
    seen.append(_zones(sup))
    seen.append(sup.restore_column(*sorted(sup.table.failed_columns)[0]))
    seen.append(sup.restore_column(0, 0))        # not quarantined
    a.last_heartbeat -= 1e6
    a.status = "running"
    seen.append(sup.check_health())
    seen.append(sup.mitigate_straggler("a", a.zone.c0)["action"])
    seen.append(_zones(sup))
    for name in sorted(sup.cells):
        sup.destroy_cell(name)
    # the declarative layer over the same primitives
    spec = spec_mod.ClusterSpec(cells=(
        spec_mod.CellSpec("x", cfg, "serve", ncols=1, max_ncols=3),
        spec_mod.CellSpec("y", cfg, "train", ncols=2, min_ncols=1,
                          max_ncols=3)))
    for s in (spec, spec.scale("x", 2).scale("y", 1), spec.scale("x", 3)
              .scale("y", 1), spec.without_cell("y")):
        for sup_restored in list(sup.table.failed_columns):
            sup.restore_column(*sup_restored)
        plan = sup.apply(s)
        seen.append([(op.verb, op.cell, op.args, op.status)
                     for op in plan.ops])
        seen.append(_zones(sup))
    seen.append(_events(sup))
    return seen


def test_supervisor_lifecycle_matches_jax():
    jcfg = smoke_config(get_arch("qwen3-4b"))
    tcfg = t_smoke_config(t_get_arch("qwen3-4b"))
    jsup = JSupervisor(JGrid.from_flat(jax.devices()[:1], 1, 1, 4,
                                       allow_reuse=True))
    tsup = Supervisor(DeviceGrid.from_flat(["cpu"], 1, 1, 4,
                                           allow_reuse=True))
    jseen = _lifecycle(jsup, jcfg, j_spec)
    tseen = _lifecycle(tsup, tcfg, t_spec)
    assert tseen == jseen
    ops = {e["op"] for e in tseen[-1]}
    assert {"create", "resize", "transfer", "spawn_child", "fail_column",
            "recover", "recover_degraded", "restore_column", "dead_cell",
            "destroy", "apply", "reconcile"} <= ops
    assert all(e["cell"] != "?" for e in tsup.events if "cell" in e)


def test_a_zone_over_two_devices_is_refused():
    """Since training runs over a mesh (ROADMAP queue 1 item 13c) nothing
    here is refused: a train cell binds a zone of two mesh positions and
    trains; a one-position train cell resizes onto two with its state bit
    for bit and trains on; a serve cell binds the two-position mesh (on
    ``meta`` it computes nothing).  What stays refused is the wrong role,
    below."""
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.param import gather_tree, jax_leaves
    cfg = t_smoke_config(t_get_arch("qwen3-4b"))
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg,
                             t_spec_shape(), device="cpu")
    two = Supervisor(DeviceGrid.from_flat(["cpu", "cpu"], 1, 1, 2))
    cell = two.create_cell("a", cfg, "train", ncols=2)
    assert cell.mesh.size == 2 and cell.model.sharded
    assert np.isfinite(cell.train_steps(pipe.get_batch, 1)["xent"])
    two.destroy_cell("a")
    cell = two.create_cell("a", cfg, "train", ncols=1)
    assert cell.device == torch.device("cpu") and cell.mesh.size == 1
    cell.train_steps(pipe.get_batch, 1)
    before = [t.clone() for t in jax_leaves(cell.state)]
    two.resize_cell("a", 2)
    assert cell.zone.ncols == 2 and cell.model.sharded
    assert all(torch.equal(a, b) for a, b in
               zip(before, jax_leaves(gather_tree(cell.state))))
    assert np.isfinite(cell.train_steps(pipe.get_batch, 1)["xent"])
    two.destroy_cell("a")
    sup = Supervisor(DeviceGrid.from_flat(["cpu", "meta"], 1, 1, 2))
    cell = sup.create_cell("s", cfg, "serve", ncols=2)
    assert cell.mesh.size == 2 and cell.n_devices == 2 and cell.model.sharded
    # the train role is a train cell's: a serve cell refuses it, and a
    # restore from a directory that holds no checkpoint is logged
    with pytest.raises(CellError, match="role 'serve'"):
        cell.init_train()
    assert sup.restore_from_ckpt(cell, "/nonexistent/ckpts/a") is False
    assert sup.events[-1]["op"] == "recover_no_ckpt"
    assert single_device_grid("cpu").shape == (1, 1, 1)


# ---------------------------------------------------------------------------
# a cell's batcher across a resize; the guard
# ---------------------------------------------------------------------------
MAX_LEN, CHUNK, PAGE = 32, 8, 8


def t_spec_shape():
    """A small train shape: 4 rows of 16 tokens."""
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("t", "train", 16, 4)


def _prompts(vocab, seed, lens):
    sysp = np.random.RandomState(1234).randint(1, vocab, size=18)
    rng = np.random.RandomState(seed)
    return [np.concatenate([sysp, rng.randint(1, vocab, size=L)])
            .astype(np.int32) for L in lens]


def _serve_wave(bat, prompts, rid0):
    for i, p in enumerate(prompts):
        bat.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=4))
    bat.run_until_drained()
    return {r.rid: r.output for r in bat.done if r.rid >= rid0}


def _cells_sup():
    tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
    sup = Supervisor(DeviceGrid.from_flat(["cpu"], 1, 1, 4,
                                          allow_reuse=True))
    spec = ClusterSpec(cells=(
        CellSpec("a", tcfg, "serve", ncols=2, min_ncols=1, max_ncols=3),
        CellSpec("b", tcfg, "serve", ncols=2, min_ncols=1, max_ncols=3)))
    sup.apply(spec)
    return sup, spec, tcfg


def test_batcher_tokens_hold_across_a_resize():
    sup, spec, tcfg = _cells_sup()
    weights = _jax_params(
        with_opt_level(_f32(smoke_config)(get_arch("qwen3-4b")), True))
    kw = dict(batch_slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
              page_size=PAGE)
    a = sup.cells["a"]
    a.init_serve(params=weights)
    bat = a.make_batcher(**kw)
    ref = ContinuousBatcher(a.model, weights, device="cpu", **kw)
    waves = [(_prompts(tcfg.vocab, 0, [3, 5, 2]), 0),
             (_prompts(tcfg.vocab, 5, [4, 7]), 10)]
    got = _serve_wave(bat, *waves[0])
    epoch = a.zone_epoch
    plan = sup.apply(spec.scale("a", 3).scale("b", 1))
    assert [op.verb for op in plan.ops] == ["transfer"]
    assert a.zone.ncols == 3 and a.zone_epoch > epoch
    assert sup.cells["a"] is a and a.live_batchers() == [(0, bat)]
    assert sup.validate_cell_programs("a") == 2      # weights + batcher
    got.update(_serve_wave(bat, *waves[1]))
    want = _serve_wave(ref, *waves[0])
    want.update(_serve_wave(ref, *waves[1]))
    assert got == want
    assert bat.pool.prefix_hit_tokens == ref.pool.prefix_hit_tokens > 0
    # the recorder closed every request's tree, across the resize
    rec = a.accounting.recorder
    assert rec.open_spans == []
    assert sorted(e["trace_id"] for e in rec.log if e["name"] == "request") \
        == sorted(got)
    # destroy drops the batchers and the weights
    sup.destroy_cell("a")
    assert a.batchers == [] and a.serve_params is None
    assert a.status == "destroyed" and "a" not in sup.cells


class _FakeEntry:
    def __init__(self, epoch, inputs):
        self.epoch, self.inputs = epoch, inputs


class _FakeGraphs:
    """A step-graph record as the card keeps it (``StepGraph.captured``),
    with the epoch of its capture."""

    def __init__(self, epoch, inputs=()):
        self.epoch = epoch
        self.entries = {("paged", 1): _FakeEntry(epoch, dict(inputs))}
        self.dropped = []

    def captured(self):
        return dict(self.entries)

    def drop(self, path):
        self.dropped.append(path)

    def release(self):
        self.entries = {}


def test_guard_refuses_off_zone_tensors_and_stale_graphs():
    sup, spec, tcfg = _cells_sup()
    a = sup.cells["a"]
    a.init_serve(generator=torch.Generator().manual_seed(0))
    bat = a.make_batcher(batch_slots=2, max_len=MAX_LEN, page_size=PAGE)
    assert sup.validate_cell_programs("a") == 2
    # a graph captured at the cell's epoch passes; its inputs are checked
    bat.step_graph = _FakeGraphs(a.zone_epoch,
                                 {"tokens": torch.zeros(2, 1)})
    assert sup.validate_cell_programs("a") == 3
    # a graph record from an older epoch is stale
    bat.step_graph = _FakeGraphs(a.zone_epoch - 1)
    with pytest.raises(BoundaryViolation, match="stale graph"):
        sup.validate_cell_programs("a")
    with pytest.raises(BoundaryViolation, match="stale graph"):
        sup.guard.validate(a, Program("g", [], epoch=a.zone_epoch - 1))
    # a resize drops every path's graphs and moves the epoch on
    sup.apply(spec.scale("a", 1).scale("b", 3))
    assert bat.step_graph.dropped == ["decode", "prefill", "extend",
                                      "restore"]
    assert bat.step_graph.epoch == a.zone_epoch
    bat.step_graph = None
    assert sup.validate_cell_programs("a") == 2
    # a cell tensor on meta while the zone is cpu
    key = next(iter(a.serve_params))
    a.serve_params[key] = torch.empty(1, device="meta")
    with pytest.raises(BoundaryViolation, match="meta"):
        sup.validate_cell_programs("a")
    with pytest.raises(BoundaryViolation, match="outside its zone"):
        sup.guard.validate(a, Program("x", [torch.empty(1, device="meta")]))
    assert tree_leaves(a.serve_params)


def test_a_dropped_batcher_is_collected_live_ones_keep_their_programs():
    sup, spec, tcfg = _cells_sup()
    a = sup.cells["a"]
    a.init_serve(generator=torch.Generator().manual_seed(0))
    kw = dict(batch_slots=2, max_len=MAX_LEN, page_size=PAGE)
    first = a.make_batcher(**kw)
    live = a.make_batcher(**kw)
    live.step_graph = _FakeGraphs(a.zone_epoch, {"tokens": torch.zeros(2)})
    gone, arena = weakref.ref(first), weakref.ref(first.pool.arena[0].k)
    assert [p.name for p in a.programs()] == [
        "serve_params", "batcher0", "batcher1", "batcher1('paged', 1)"]
    del first
    gc.collect()
    assert gone() is None and arena() is None     # collected, arena too
    # the live batcher keeps its number: no guard report renames it
    assert [p.name for p in a.programs()] == [
        "serve_params", "batcher1", "batcher1('paged', 1)"]
    assert sup.validate_cell_programs("a") == 3
    assert a.batchers == [live]
    # a resize still drops the live batcher's graphs and moves its epoch
    sup.apply(spec.scale("a", 1).scale("b", 3))
    assert live.step_graph.dropped == ["decode", "prefill", "extend",
                                       "restore"]
    assert live.step_graph.epoch == a.zone_epoch
    later = a.make_batcher(**kw)
    assert a.live_batchers() == [(1, live), (2, later)]
    sup.destroy_cell("a")
    assert a.batchers == [] and a.live_batchers() == []


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------
def test_control_plane_unicast_multicast_broadcast():
    cp = ControlPlane()
    for n in ("sup", "a", "b", "c"):
        cp.register(n)
    cp.unicast("sup", "a", "resize", {"ncols": 3})
    m = cp.poll("a")
    assert m.kind == "resize" and m.payload["ncols"] == 3 and m.src == "sup"
    assert cp.poll("a") is None
    cp.multicast("sup", ["a", "b"], "ping")
    assert cp.poll("a").kind == "ping" and cp.poll("b").kind == "ping"
    assert cp.poll("c") is None
    cp.broadcast("a", "hello")
    assert {n for n in ("sup", "b", "c") if cp.poll(n)} == {"sup", "b", "c"}
    assert cp.poll("a") is None
    cp.unicast("sup", "c", "x", 1)
    cp.unicast("b", "c", "y", 2)
    assert [(m.src, m.kind, m.payload) for m in cp.drain("c")] == \
        [("sup", "x", 1), ("b", "y", 2)]
    assert dict(cp.stats) == {"unicast": 8, "multicast": 1, "broadcast": 1}
    with pytest.raises(ChannelError):
        cp.unicast("sup", "ghost", "x")
    cp.unregister("b")
    with pytest.raises(ChannelError):
        cp.unicast("sup", "b", "x")


def test_array_channel_round_trips():
    sup, spec, tcfg = _cells_sup()
    ch = sup.open_channel("a", "b", kind="pages")
    assert sup.find_channel("a", "b", "pages") is ch
    assert sup.find_channel("b", "a", "pages") is None
    tree = {"k": torch.arange(12, dtype=torch.float32).view(3, 4),
            "v": [torch.ones(2, 2, dtype=torch.bfloat16)], "n": 3}
    stats = ch.send(tree)
    assert stats["bytes"] == 12 * 4 + 4 * 2
    got = ch.recv()
    assert torch.equal(got["k"], tree["k"]) and got["n"] == 3
    assert got["k"].data_ptr() != tree["k"].data_ptr()      # a copy
    ch.send_kv({"k": tree["k"]}, meta={"rid": 5})
    env = ch.recv_kv()
    assert isinstance(env, KVEnvelope) and env.meta == {"rid": 5}
    pages = [torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(1))]
    ch.send_pages(pages, meta={"tree": [1, 2]})
    env = ch.poll_pages()
    assert torch.equal(env.cache[0], pages[0]) and env.meta["tree"] == [1, 2]
    assert ch.poll_kv() is None
    assert ch.map(tree)["zero_copy"] and ch.recv() is tree   # one device
    assert (ch.bytes_sent, ch.transfers) == (56 + 48 + 256, 4)
    ch.send(tree)
    with pytest.raises(ChannelError, match="not a KV envelope"):
        ch.recv_kv()
    ch.recv()
    with pytest.raises(ChannelError, match="empty"):
        ch.recv()
    rec = sup.cells["a"].accounting.recorder
    assert [e["name"] for e in rec.log] == ["xfer:pages"] * 4
    assert rec.hists["xfer_pages_bytes"].count == 4
    sup.destroy_cell("b")                # closes the channel
    assert not ch.open and sup.find_channel("a", "b", "pages") is None
    with pytest.raises(ChannelError, match="closed"):
        ch.send(tree)


# ---------------------------------------------------------------------------
# the train role: checkpoints and recovery
# ---------------------------------------------------------------------------
def _train_setup(tmp_path, cols=2):
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
    sup = Supervisor(DeviceGrid.from_flat(["cpu"], 1, 1, cols,
                                          allow_reuse=True))
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    sup.apply(ClusterSpec(cells=(CellSpec("t", cfg, "train", ncols=1,
                                          opt_cfg=opt,
                                          ckpt_dir=str(tmp_path)),)))
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg,
                             ShapeConfig("t", "train", 16, 4), device="cpu")
    cell = sup.cells["t"]
    cell.init_train(torch.Generator().manual_seed(0))
    return sup, cell, pipe


def _losses(cell, pipe, n):
    return [cell.train_steps(pipe.get_batch, 1)["loss_step"]
            for _ in range(n)]


def _uninterrupted(tmp_path):
    sup, cell, pipe = _train_setup(tmp_path / "ref")
    return _losses(cell, pipe, 4)


@pytest.mark.parametrize("how", ["recover_cell", "reconcile"])
def test_a_killed_train_cell_resumes_from_its_checkpoint(tmp_path, how):
    from repro_torch.checkpoint import checkpoint as ckpt
    want = _uninterrupted(tmp_path)
    sup, cell, pipe = _train_setup(tmp_path / "run")
    got = _losses(cell, pipe, 2)
    ckpt.save(str(tmp_path / "run"), cell.step, cell.state,
              blocking=False).result(timeout=60)
    _losses(cell, pipe, 1)                   # lost with the cell
    sup.fail_column(0, cell.zone.c0)
    if how == "recover_cell":
        new = sup.recover_cell("t", ckpt_dir=str(tmp_path / "run"))
    else:
        sup.reconcile()
        new = sup.cells["t"]
    assert new is not cell and new.status == "running" and new.step == 2
    assert [e["op"] for e in sup.events if e["op"] in
            ("fail_column", "restore_ckpt", "recover")] == \
        ["fail_column", "restore_ckpt", "recover"]
    got += _losses(new, pipe, 2)
    assert got == want
    assert sup.validate_cell_programs("t") == 2   # state, train step
    prog = new.accounting.programs["train_step"]
    assert prog.flops_per_device > 0 and prog.invocations == 2


def test_a_resize_mid_run_keeps_the_losses(tmp_path):
    want = _uninterrupted(tmp_path)
    sup, cell, pipe = _train_setup(tmp_path / "run")
    got = _losses(cell, pipe, 2)
    epoch = cell._train_step[1]
    sup.resize_cell("t", 2)
    assert cell._train_step is None           # the step is rebuilt
    got += _losses(cell, pipe, 2)
    assert got == want and cell._train_step[1] > epoch
    sup.validate_cell_programs("t")


def test_recover_with_a_checkpoint_matches_jax_events(tmp_path):
    """The JAX and port supervisors recover a train cell from a
    checkpoint of its state with the same events, zones and step."""
    from repro.checkpoint import checkpoint as j_ckpt
    from repro_torch.checkpoint import checkpoint as t_ckpt
    jcfg = smoke_config(get_arch("qwen3-4b"))
    tcfg = t_smoke_config(t_get_arch("qwen3-4b"))
    seen = []
    for sup, cfg, ck, init in (
            (JSupervisor(JGrid.from_flat(jax.devices()[:1], 1, 1, 3,
                                         allow_reuse=True)), jcfg, j_ckpt,
             lambda c: c.init_train(jax.random.PRNGKey(0))),
            (Supervisor(DeviceGrid.from_flat(["cpu"], 1, 1, 3,
                                             allow_reuse=True)), tcfg, t_ckpt,
             lambda c: c.init_train(torch.Generator().manual_seed(0)))):
        d = str(tmp_path / "ck")      # one name in both event logs
        cell = sup.create_cell("t", cfg, "train", ncols=1)
        init(cell)
        ck.save(d, 6, cell.state)
        sup.fail_column(0, cell.zone.c0)
        new = sup.recover_cell("t", ckpt_dir=d)
        sup.fail_column(0, new.zone.c0)
        sup.recover_cell("t", ckpt_dir=str(tmp_path / "empty"))
        seen.append((_events(sup), _zones(sup), new.step, new.status))
    assert seen[1] == seen[0]


def test_a_serve_cell_restores_its_params(tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt
    cfg = t_smoke_config(t_get_arch("qwen3-4b"))
    sup = Supervisor(DeviceGrid.from_flat(["cpu"], 1, 1, 2,
                                          allow_reuse=True))
    cell = sup.create_cell("srv", cfg, "serve", ncols=1)
    cell.init_serve(generator=torch.Generator().manual_seed(0))
    ref = [t.clone() for t in tree_leaves(cell.serve_params)]
    ckpt.save(str(tmp_path), 7, cell.snapshot_state())
    cell.status = "failed"
    rec = sup.recover_cell("srv", ckpt_dir=str(tmp_path))
    assert rec.status == "running" and rec.step == 7 and rec.state is None
    got = tree_leaves(rec.serve_params)
    assert len(got) == len(ref)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    rec.status = "failed"
    rec2 = sup.recover_cell("srv", ckpt_dir=str(tmp_path / "empty"))
    assert rec2.serve_params is None
    assert [e["op"] for e in sup.events[-2:]] == ["recover_no_ckpt",
                                                  "recover"]
