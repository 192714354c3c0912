"""Cell — the subOS abstraction for GPU computing.

A cell *directly manages* its resources: it owns its zone's device, builds
its own model and batchers there, holds its serve state, and runs steps
without any supervisor involvement on the step path.  The supervisor
only creates/destroys/resizes it — and applications do not call even
those verbs directly: they declare a :class:`~repro_torch.core.spec.CellSpec`
(arch, role, ``[min,max]`` column bounds, replicas, SLO targets) inside a
ClusterSpec, and the reconciler (``Supervisor.apply``/``reconcile``)
drives the primitives that keep this cell converged to it.

Paper §4.3 properties implemented here:
  1. management facility      -> CellSpec desired state; the reconciler
                                 executes create/destroy/resize_cell as
                                 its plan-executor layer
  2. exact accounting         -> CellAccounting + the cell's flight
                                 recorder, handed to every batcher the
                                 cell makes (per-request TTFT/TPOT, what
                                 elastic ReconcilePolicies read)
  3. IPC-like channels        -> ArrayChannel / ControlPlane endpoints
                                 (declared via ChannelSpec or opened on
                                 demand)
  4. fork-like spawn          -> Supervisor.spawn_child (sub-zone carved
                                 from the parent; lineage() walks it)

A cell runs over its zone's mesh (``DeviceGrid.zone_mesh``).  A mesh of
one position is the one-device cell (a zone whose columns all name one
card of a cycled grid, ``DeviceGrid.from_flat(..., allow_reuse=True)``).
Over any zone the partition table carves, the R rows of its columns on
one pod, (``data`` R, ``model`` C), or on several pods, (``pod``,
``data``, ``model``), a serve cell of any family binds ``make_ctx(mesh)``
(the JAX cell's rules, FSDP on: a weight's ``embed`` dim split over the
data axes and gathered layer by layer) and builds its model over it:
weights laid out by the rules, layers tensor- and expert-parallel (Mamba
layers over their SSD heads, the encoder-decoder's attention and
cross-attention over heads), the batch split over the data axes,
batchers over the sharded model with one host schedule (one slot table,
one pool), the pool's arena and a snapshot pool's payloads whole on every
data row.  A train cell binds the same ctx: its state (params, AdamW
moments, error-feedback buffers) is laid out by ``train_state_pspecs``,
the batch splits over the data axes, each position runs the train step's
forward and backward on its part, and the gradient of every copy of a
leaf is reduced before AdamW updates it shard by shard
(``train/train_step.py``).  A cell's programs
are the step graphs of the batchers it made and of a disaggregated
prefill worker on it
(``serve/step_graph.py``), bound to the zone epoch they were captured
at: a resize drops them, and each key captures again at its next visit.
The cell holds them weakly: one its caller drops goes with its memory.
A train cell's program is its train step (``train/train_step.py``),
built at the zone epoch of its first ``train_steps`` after a bind; its
state (``TrainState``: params, AdamW moments, error-feedback buffers)
moves with a resize as serve weights do.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.accounting import CellAccounting
from repro_torch.core.guard import BoundaryGuard, Program
from repro_torch.core.partition import DeviceGrid, Zone
from repro_torch.core.resharding import reshard_tree
from repro_torch.models.model import build_model
from repro_torch.models.param import tree_leaves
from repro_torch.sharding.collectives import recording
from repro_torch.sharding.rules import make_ctx
from repro_torch.serve.step_graph import PATHS
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (
    TrainState,
    build_train_step,
    init_train_state,
    step_cost,
    train_state_pspecs,
)


class CellError(Exception):
    pass


class Cell:
    def __init__(
        self,
        name: str,
        zone: Zone,
        grid: DeviceGrid,
        arch: ArchConfig,
        role: str,                       # "train" | "serve"
        *,
        epoch: int,
        opt_cfg: Optional[OptConfig] = None,
        parent: Optional[str] = None,
    ):
        self.name = name
        self.arch = arch
        self.role = role
        self.parent = parent
        self.grid = grid
        self.opt_cfg = opt_cfg or OptConfig()
        self.accounting = CellAccounting(name)
        self.status = "created"
        self.step = 0
        self.last_heartbeat = time.monotonic()
        self.state: Optional[TrainState] = None
        self._compress = False
        self.serve_params = None
        self.serve_cache = None
        # the batchers this cell made, held weakly as (number, ref): a
        # batcher its caller drops is collected with its arena, as JAX's
        # cell keeps none; the number names it in programs() for life
        self._batchers: List[Tuple[int, weakref.ref]] = []
        self._made = 0
        self._bind_zone(zone, epoch)

    # ------------------------------------------------------------------
    # zone binding / resize
    # ------------------------------------------------------------------
    def _bind_zone(self, zone: Zone, epoch: int):
        mesh = self.grid.zone_mesh(zone)
        ctx = make_ctx(mesh) if mesh.size > 1 else None
        self.zone = zone
        self.mesh = mesh
        self.ctx = ctx
        self.devices = mesh.distinct_devices()
        self.device = mesh.positions[0]
        self.model = build_model(self.arch, ctx)
        self.bound_epoch = epoch      # epoch programs are captured under
        self.zone_epoch = epoch       # epoch of the last zone change
        self._train_step = None       # (step fn, epoch it was built at)
        for bat in self.batchers:     # the JAX cell's _programs.clear()
            if bat.step_graph is not None:
                for path in PATHS:
                    bat.step_graph.drop(path)
                bat.step_graph.epoch = epoch

    def live_batchers(self) -> List[Tuple[int, object]]:
        """(number, batcher) of each batcher this cell made that is still
        alive, in the order made; dead references are pruned."""
        live = [(n, ref, ref()) for n, ref in self._batchers]
        self._batchers = [(n, ref) for n, ref, b in live if b is not None]
        return [(n, b) for n, _, b in live if b is not None]

    @property
    def batchers(self) -> list:
        """The live batchers this cell made."""
        return [b for _, b in self.live_batchers()]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def _relay(self, tree):
        """``tree`` onto the cell's zone: its mesh by the model's rules
        (a TrainState by ``train_state_pspecs``), or its one device."""
        if self.ctx is None:
            return reshard_tree(tree, self.device)
        if isinstance(tree, TrainState):
            pspecs = train_state_pspecs(self.model,
                                        compress=tree.ef is not None)
        else:
            pspecs = self.model.params_pspecs()
        return reshard_tree(tree, self.ctx, pspecs)

    def heartbeat(self):
        self.last_heartbeat = time.monotonic()

    # ------------------------------------------------------------------
    # training role
    # ------------------------------------------------------------------
    def init_train(self, generator: Optional[torch.Generator] = None, *,
                   compress: bool = False) -> TrainState:
        """A fresh TrainState on the cell's zone: ``model.init``'s seeded
        weights from ``generator`` (default: seed 0 on the device of the
        first position), zero AdamW moments and, with ``compress``,
        error-feedback buffers; over a mesh laid out by
        ``train_state_pspecs`` (the weights drawn whole, then split)."""
        if self.role != "train":
            raise CellError(f"cell {self.name!r} has role {self.role!r}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.state = init_train_state(self.model, generator, self.opt_cfg,
                                      compress=compress, device=self.device)
        self._compress = compress
        self.status = "running"
        return self.state

    def train_steps(self, batches, n: int) -> dict:
        """Run n steps; batches: callable step -> batch.

        The first call after a bind builds the step for this zone, runs
        the BoundaryGuard over it (the state, every position's shards of
        it, and the batch on the zone's devices, the step bound to the
        zone's epoch) and registers its cost with the cell's accounting:
        per position, reckoned from the config and the batch shape
        (``step_cost``), with the collective bytes its first run moved
        (``collectives.recording``).  Returns the last step's metrics as
        floats.
        """
        if self.state is None:
            self.init_train()
        metrics = {}
        for _ in range(n):
            batch = batches(self.step)
            fresh = self._train_step is None
            if fresh:
                self._train_step = (build_train_step(
                    self.model, self.opt_cfg, compress=self._compress),
                    self.zone_epoch)
                BoundaryGuard(lambda: None).validate(self, Program(
                    "train_step", tree_leaves(self.state) + tree_leaves(batch),
                    self.zone_epoch))
            with (recording() if fresh else contextlib.nullcontext()) as moved:
                self.state, metrics = self._train_step[0](self.state, batch)
            if fresh:
                self.accounting.register_program(
                    "train_step", collective=dict(moved),
                    **step_cost(self.model, self.opt_cfg, batch,
                                compress=self._compress))
            self.step += 1
            self.heartbeat()
        self.accounting.record_invocation("train_step", n)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    # serving role
    # ------------------------------------------------------------------
    def init_serve(self, params=None,
                   generator: Optional[torch.Generator] = None):
        """Place serving weights on the cell's zone: ``params`` as given
        (moved there; over a mesh, laid out by the model's rules), else
        ``model.init``'s seeded weights from ``generator`` (default: seed
        0 on the device of the first position), the weights a directly
        built batcher gets from the same generator."""
        if self.role != "serve":
            raise CellError(f"cell {self.name!r} has role {self.role!r}")
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = self.model.init(generator, device=self.device)
        else:
            params, _ = self._relay(params)
        self.serve_params = params
        self.status = "running"
        return self.serve_params

    def make_batcher(self, *, batch_slots: int, max_len: int, **kw):
        """A batcher over the cell's weights on its device, reporting to
        the cell's accounting and flight recorder.  The cell holds it
        weakly (its graphs are the cell's programs while it lives); the
        caller's reference keeps it alive."""
        from repro_torch.serve.batcher import ContinuousBatcher
        if self.serve_params is None:
            self.init_serve()
        kw.setdefault("accounting", self.accounting)
        kw.setdefault("device", self.device)
        bat = ContinuousBatcher(
            self.model, self.serve_params,
            batch_slots=batch_slots, max_len=max_len, **kw,
        )
        return self.track(bat)

    def track(self, engine):
        """Hold ``engine`` (a batcher, or a disaggregated prefill worker:
        anything with ``step_graph``, ``state_tensors()`` and ``close()``)
        weakly among the cell's programs, its graphs bound to the zone
        epoch; returns it."""
        if engine.step_graph is not None:
            engine.step_graph.epoch = self.zone_epoch
        self._batchers.append((self._made, weakref.ref(engine)))
        self._made += 1
        return engine

    def programs(self) -> List[Program]:
        """What the BoundaryGuard checks: the serving weights, each
        live batcher's state, and each captured graph with its static
        inputs and capture epoch; a batcher is named by its number.  A
        train cell's state, and its train step with its build epoch."""
        if self.role == "train":
            out = [Program("train_state", tree_leaves(self.state))]
            if self._train_step is not None:
                out.append(Program("train_step", tree_leaves(self.state),
                                   self._train_step[1]))
            return out
        out = [Program("serve_params", tree_leaves(self.serve_params))]
        for i, bat in self.live_batchers():
            state = bat.state_tensors()
            out.append(Program(f"{bat.PROGRAM}{i}", state))
            if bat.step_graph is None:
                continue
            for key, entry in bat.step_graph.captured().items():
                out.append(Program(f"{bat.PROGRAM}{i}{key}",
                                   state + list(entry.inputs.values()),
                                   entry.epoch))
        return out

    # ------------------------------------------------------------------
    # resize: live reshard onto the new zone
    # ------------------------------------------------------------------
    def resize_to(self, zone: Zone, epoch: int) -> dict:
        """Bind the new zone (dropping every graph of the cell's
        batchers, and its train step: the next visit of a key captures,
        and the next ``train_steps`` builds, under ``epoch``) and move the
        serve weights or the train state onto it (no copy on the same
        device; from one mesh to another each leaf is re-laid and its
        old shards freed).  The batchers keep serving, rebound to the new
        model and weights when the mesh changed."""
        old, old_size = self.zone, self.mesh.size
        state = self.state if self.role == "train" else self.serve_params
        self._bind_zone(zone, epoch)
        stats = {"bytes": 0, "seconds": 0.0}
        if state is not None:
            new_state, stats = self._relay(state)
            if self.role == "train":
                self.state = new_state
            else:
                self.serve_params = new_state
        if old_size > 1 or self.mesh.size > 1:
            for bat in self.batchers:
                bat.rebind(self.model, self.serve_params)
        stats.update(old=f"{old.ncols}cols", new=f"{zone.ncols}cols")
        return stats

    # ------------------------------------------------------------------
    def snapshot_state(self):
        return self.state if self.role == "train" else self.serve_params

    def destroy(self):
        """Close the cell's live batchers (their graph pools) and drop
        every reference the cell holds; the memory returns to the
        allocator once the caller drops its own references too."""
        self.status = "destroyed"
        for bat in self.batchers:
            bat.close()
        self._batchers = []
        self.state = None
        self._train_step = None
        self.serve_params = None
        self.serve_cache = None
