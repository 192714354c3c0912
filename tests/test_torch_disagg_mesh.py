"""Disaggregated serving over cells of several mesh positions (CPU,
float32): the port's ``DisaggServer`` over a prefill cell and decode
replicas that each lie over a mesh, against the JAX package's one-device
server on the same weights and requests.

* Three layouts, the cells of one supervisor sharing its grid's rows:
  on a 1-row grid a prefill cell over (1, 2) feeding replicas over (1, 1)
  (the kv heads of the smoke deepseek cross from split to whole), over
  (1, 1) feeding replicas over (1, 2); on a 2-row grid a prefill cell
  over (2, 2) feeding replicas over (2, 1).
* Five scenarios of ``tests/test_torch_disagg.py`` and
  ``tests/test_torch_cacheplane.py`` in each: the KV handoff round trip,
  the weight fan-out to a second replica, a failed replica's requests
  requeued, replicas attached and detached by ``sync``, and a scale-down
  that drains a replica (pages migrated, slots handed off).  The tokens
  must be JAX's, and so must the counters: KV transfers, ``kv_bytes`` in
  logical bytes, requeues, pages migrated, handoffs, prefix-hit tokens,
  warm and cold routings, the channels opened and every request's span
  names.
* ``tests/test_torch_disagg_mesh_families.py`` runs the cold + warm +
  drain scenario for all five families.
* A weight fan-out and a page export over a mesh leave the sender's
  params and arena intact: the sender serves afterwards as before; a
  zero-copy ``map`` between two layouts of one device is refused.
* A prefill cell resized from (1, 1) to (1, 2) between two waves: its
  worker is rebound onto the new mesh and the tokens stay JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro_torch.core.channels import ChannelError  # noqa: E402
from repro_torch.models.param import gather_tree, tree_leaves  # noqa: E402
from repro_torch.sharding.sharded import gather_leaf  # noqa: E402
from test_torch_disagg import Side, counters  # noqa: E402

MAX_LEN = 48
#: (grid rows, prefill ncols, decode ncols)
LAYOUTS = {"prefill-1x2-decode-1x1": (1, 2, 1),
           "prefill-1x1-decode-1x2": (1, 1, 2),
           "prefill-2x2-decode-2x1": (2, 2, 1)}
_JAX = {}


class MeshSide(Side):
    """``Side`` whose port cells lie over a mesh: a grid of ``cpu``
    positions with ``rows`` rows of 8 columns, the prefill and decode
    cells ``ncols`` wide each; the JAX side keeps one device."""

    def __init__(self, port, arch, layout=(1, 1, 1)):
        super().__init__(port, arch)
        self.rows, self.p_cols, self.d_cols = layout

    def supervisor(self, cols=8):
        if not self.port:
            return super().supervisor(cols)
        return self.core.Supervisor(self.core.DeviceGrid.from_flat(
            ["cpu"] * (8 * self.rows), 1, self.rows, 8))

    def ncols(self, role):
        if not self.port:
            return 1
        return self.p_cols if role == "prefill" else self.d_cols

    def spec(self, replicas, **kw):
        c = self.core
        return c.ClusterSpec(
            cells=(c.CellSpec("prefill", self.cfg, "serve",
                              ncols=self.ncols("prefill")),
                   c.CellSpec("decode", self.cfg, "serve",
                              ncols=self.ncols("decode"),
                              replicas=replicas, **kw)),
            channels=(c.ChannelSpec("prefill", "decode", kind="kv"),))

    def server(self, sup, decode, **kw):
        return self.disagg.DisaggServer(
            sup, "prefill", decode, batch_slots=2, max_len=MAX_LEN, chunk=16,
            **kw)

    def requests(self, lens, *, shared=0, max_new=4, seed=0, rid0=0):
        """Prompts of ``lens`` behind a ``shared`` system prefix (encdec:
        one source for all)."""
        srng = np.random.RandomState(1234)
        sysp = srng.randint(1, self.cfg.vocab, size=shared).astype(np.int32)
        rng = np.random.RandomState(seed)
        out = []
        for i, L in enumerate(lens):
            src = (np.random.RandomState(99).randn(9, self.cfg.d_model)
                   .astype(np.float32) if self.cfg.family == "encdec"
                   else None)
            out.append(self.Request(
                rid=rid0 + i, max_new_tokens=max_new, src=src,
                prompt=np.concatenate([
                    sysp, rng.randint(1, self.cfg.vocab, size=L)
                    .astype(np.int32)])))
        return out


def observed(side, sup, srv) -> dict:
    st = srv.stats()
    return {**counters(side, sup, srv),
            **{k: st[k] for k in ("kv_bytes", "pages_migrated",
                                  "drain_handoffs", "routed_warm",
                                  "routed_cold")}}


def drained(srv, **kw):
    return {r.rid: list(r.output) for r in srv.run_until_drained(**kw)}


# --------------------------------------------------------------------------
# the scenarios: (tokens, observables) of one side
# --------------------------------------------------------------------------
def roundtrip(side):
    sup = side.supervisor()
    sup.create_cell("prefill", side.cfg, "serve", ncols=side.ncols("prefill"))
    side.init(sup.create_cell("decode", side.cfg, "serve",
                              ncols=side.ncols("decode")))
    srv = side.server(sup, "decode")
    for r in side.requests([3, 33, 17, 40], max_new=5):
        srv.submit(r)
    return drained(srv), observed(side, sup, srv)


def fanout(side):
    sup = side.supervisor()
    spec = side.spec(2)
    sup.apply(spec)
    side.init(sup.cells["decode/0"])
    srv = side.server(sup, spec.cell("decode").instances())
    for r in side.requests([9, 33, 17, 21, 40, 12], max_new=3):
        srv.submit(r)
    return drained(srv), observed(side, sup, srv)


def failed_replica(side):
    sup = side.supervisor()
    sup.create_cell("prefill", side.cfg, "serve", ncols=side.ncols("prefill"))
    for name in ("dec0", "dec1"):
        sup.create_cell(name, side.cfg, "serve", ncols=side.ncols("decode"))
    side.init(sup.cells["dec0"])
    srv = side.server(sup, ["dec0", "dec1"])
    for r in side.requests([9, 33, 17, 21, 40, 12], max_new=4):
        srv.submit(r)
    srv.step()
    srv.step()
    sup.fail_column(0, srv.replicas[1].cell.zone.c0)
    got = drained(srv, max_steps=2_000)
    return got, observed(side, sup, srv)


def sync_attach_detach(side):
    sup = side.supervisor()
    spec = side.spec(3, min_replicas=1, max_replicas=3)
    sup.apply(spec)
    side.init(sup.cells["decode/0"])
    srv = side.server(sup, spec.cell("decode").instances())
    for r in side.requests([9, 33, 17, 21], max_new=4):
        srv.submit(r)
    srv.step()
    syncs = []
    for n in (2, 3):
        sup.apply(sup.desired.with_cell(dataclasses.replace(
            sup.desired.cell("decode"), replicas=n)))
        syncs.append(srv.sync(sup.desired))
    got = drained(srv, max_steps=2_000)
    return got, {**observed(side, sup, srv), "syncs": syncs}


def drain(side):
    """Three cold prompts behind a shared prefix, one a replica; then three
    cold prompts (one a replica again) and a warm one, and a scale-down
    from 3 replicas to 2 while they decode: the doomed replica's pages
    migrate and its slot is handed off (a snapshot pool's slot
    requeues)."""
    sup = side.supervisor()
    spec = side.spec(3, min_replicas=1, max_replicas=3)
    sup.apply(spec)
    side.init(sup.cells["decode/0"])
    srv = side.server(sup, spec.cell("decode").instances(), migrate=True,
                      page_size=8)
    for r in side.requests([11, 13, 10], shared=18, max_new=3):
        srv.submit(r)
    first = drained(srv, max_steps=2_000)
    for r in (side.requests([20, 22, 9], max_new=6, seed=7, rid0=10)
              + side.requests([5], shared=18, max_new=6, seed=8, rid0=20)):
        srv.submit(r)
    srv.step()
    held = sum(s is not None for s in srv.replicas[2].batcher.slot_req)
    sup.apply(sup.desired.with_cell(dataclasses.replace(
        sup.desired.cell("decode"), replicas=2)))
    out = srv.sync(sup.desired)
    got = drained(srv, max_steps=2_000)
    return {**first, **got}, {**observed(side, sup, srv), "held": held,
                              "sync": out}


SCENARIOS = {"roundtrip": roundtrip, "fanout": fanout,
             "failed_replica": failed_replica,
             "sync_attach_detach": sync_attach_detach, "drain": drain}


def jax_run(name, arch="qwen3-4b"):
    if (name, arch) not in _JAX:
        _JAX[name, arch] = SCENARIOS[name](MeshSide(False, arch))
    return _JAX[name, arch]


def check(name, arch, layout):
    (jt, jc) = jax_run(name, arch)
    tt, tc = SCENARIOS[name](MeshSide(True, arch, LAYOUTS[layout]))
    assert tt == jt
    assert tc == jc
    return tt, tc


# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_disaggregated_serving_over_meshes_matches_jax(name, layout):
    tokens, c = check(name, "qwen3-4b", layout)
    assert tokens and all(tokens.values())
    assert c["kv_bytes"] > 0 and c["open_spans"] == 0
    if name == "failed_replica":
        assert c["requeued"] >= 1 and c["replicas"] == ["dec0"]
    if name == "sync_attach_detach":
        assert c["syncs"][1]["attached"] == ["decode/2"]
    if name == "drain":
        assert c["sync"]["requeued"] == 0
        assert c["drain_handoffs"] == c["held"] == 1
        assert c["pages_migrated"] > 0 and c["routed_warm"] > 0


def test_fanout_and_page_export_leave_the_sender_serving():
    """A cell over (2, 1) fans its weights out to a cell over (2, 2)
    and exports its interned pages to it; the sender's
    params and arena are bitwise as before, and it serves a second wave
    with the tokens of a sender that exported nothing."""
    from repro_torch.serve.cacheplane import migrate_prefixes

    def serve(side, migrate):
        sup = side.supervisor()
        a = sup.create_cell("a", side.cfg, "serve", ncols=1)
        b = sup.create_cell("b", side.cfg, "serve", ncols=2)
        side.init(a)
        bat = a.make_batcher(batch_slots=2, max_len=MAX_LEN, page_size=8,
                             device="cpu")
        for r in side.requests([3, 5], shared=18, max_new=3):
            bat.submit(r)
        bat.run_until_drained()
        before = ([t.clone() for t in tree_leaves(gather_tree(
            a.serve_params))], [gather_leaf(x).clone()
                                for x in bat.pool.arena[0]])
        if migrate:
            ch = sup.open_channel("a", "b", kind="array")
            with pytest.raises(ChannelError, match="zero-copy"):
                ch.map(a.serve_params)      # one device, two layouts
            ch.send(a.serve_params, (b.mesh, b.model.params_pspecs()))
            b.serve_params = ch.recv()
            other = b.make_batcher(batch_slots=2, max_len=MAX_LEN,
                                   page_size=8, device="cpu")
            assert migrate_prefixes(bat.pool, other.pool, sup.open_channel(
                "a", "b", kind="pages")) == bat.pool.tree.interned > 0
            after = ([t for t in tree_leaves(gather_tree(a.serve_params))],
                     [gather_leaf(x) for x in bat.pool.arena[0]])
            assert all(torch.equal(x, y) for x, y in zip(
                before[0] + before[1], after[0] + after[1]))
            assert all(torch.equal(x, y) for x, y in zip(
                before[0], tree_leaves(gather_tree(b.serve_params))))
        for r in side.requests([9, 4], shared=18, max_new=4, seed=3,
                               rid0=10):
            bat.submit(r)
        return {r.rid: list(r.output) for r in bat.run_until_drained()}

    side = MeshSide(True, "qwen3-4b", (2, 1, 1))
    assert serve(side, True) == serve(side, False)


def test_a_prefill_cell_resized_between_waves_keeps_serving():
    """The round trip with the prefill cell grown from (1, 1) to (1, 2)
    between two waves: its worker is rebound (pool, steps, scratch) onto
    the new mesh, and the tokens and counters stay JAX's."""
    def run(side):
        sup = side.supervisor()
        sup.create_cell("prefill", side.cfg, "serve", ncols=1)
        side.init(sup.create_cell("decode", side.cfg, "serve",
                                  ncols=side.ncols("decode")))
        srv = side.server(sup, "decode")
        for r in side.requests([3, 33], shared=18, max_new=4):
            srv.submit(r)
        first = drained(srv)
        if side.port:
            sup.resize_cell("prefill", 2)
            assert srv.worker.model.ctx.mesh.size == 2
            assert srv.worker.pool.arena[0].k.mesh is sup.cells[
                "prefill"].mesh
        for r in side.requests([17, 40], shared=18, max_new=4, seed=3,
                               rid0=10):
            srv.submit(r)
        return {**first, **drained(srv)}, observed(side, sup, srv)

    jt, jc = run(MeshSide(False, "qwen3-4b"))
    tt, tc = run(MeshSide(True, "qwen3-4b", (1, 1, 1)))
    assert tt == jt and len(tt) == 4
    assert {k: tc[k] for k in ("kv_transfers", "kv_bytes",
                               "prefix_hit_tokens", "invocations")} == \
        {k: jc[k] for k in ("kv_transfers", "kv_bytes",
                            "prefix_hit_tokens", "invocations")}
