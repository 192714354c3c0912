"""On-demand inter-cell communication (FICM / RFcom / RFloop analogues).

Confined state sharing: no channel exists until two endpoints open one, and
a channel's shared state is visible only to its two endpoints — mirroring
the paper's FICM message channels (unicast/multicast/broadcast) and
RFcom's ``rf_open/rf_read/rf_write/rf_map`` surface.

* Control plane (:class:`ControlPlane`): small messages over per-edge
  queues; on a real deployment this is the host network, here in-process.
* Data plane (:class:`ArrayChannel`): tensor transfer between two cells
  via ``Tensor.to(device, non_blocking=True)`` (NVLink or PCIe between
  cards, a device-to-device copy within one — the RFloop analogue:
  packets between co-located cells never leave the machine).  The
  target is a device, or a layout over the destination's mesh: its
  ``Mesh`` and a PartitionSpec tree of the sent tree (JAX's
  ``target_shardings``), each leaf gathered to its logical tensor and
  laid out anew, the sender's tensors left intact.  A transfer records
  a CUDA event on each destination card after its copies; the
  receiver's streams wait on them at ``recv``, so the sender never
  blocks on the copy.  ``map`` publishes tensors to the peer without
  copying when the two zones share a device and a layout
  (shared-memory mapping analogue).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.resharding import tree_bytes
from repro_torch.core.telemetry import recorder_of
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import Sharded, relay_leaf, same_mesh


class ChannelError(Exception):
    pass


@dataclasses.dataclass
class Message:
    src: str
    kind: str
    payload: Any
    ts: float = dataclasses.field(default_factory=time.monotonic)


class ControlPlane:
    """FICM-style message channels between named endpoints."""

    def __init__(self):
        self._queues: Dict[str, deque] = defaultdict(deque)
        self._lock = threading.Lock()
        self._members: set = set()
        self.stats = defaultdict(int)

    def register(self, name: str):
        with self._lock:
            self._members.add(name)
            self._queues.setdefault(name, deque())

    def unregister(self, name: str):
        with self._lock:
            self._members.discard(name)
            self._queues.pop(name, None)

    def unicast(self, src: str, dst: str, kind: str, payload: Any = None):
        with self._lock:
            if dst not in self._members:
                raise ChannelError(f"unknown endpoint {dst!r}")
            self._queues[dst].append(Message(src, kind, payload))
            self.stats["unicast"] += 1

    def multicast(self, src: str, dsts, kind: str, payload: Any = None):
        for d in dsts:
            self.unicast(src, d, kind, payload)
        self.stats["multicast"] += 1

    def broadcast(self, src: str, kind: str, payload: Any = None):
        with self._lock:
            members = [m for m in self._members if m != src]
        for d in members:
            self.unicast(src, d, kind, payload)
        self.stats["broadcast"] += 1

    def poll(self, name: str) -> Optional[Message]:
        with self._lock:
            q = self._queues.get(name)
            return q.popleft() if q else None

    def drain(self, name: str) -> List[Message]:
        out = []
        while True:
            m = self.poll(name)
            if m is None:
                return out
            out.append(m)


@dataclasses.dataclass
class KVEnvelope:
    """One request's KV rows in flight on a channel (prefill -> decode)."""
    meta: dict
    cache: Any


class ArrayChannel:
    """RFcom-style typed tensor channel between two cells.

    ``send``/``recv`` move tensor trees onto the destination cell's
    device or a layout over its mesh; ``map`` hands over the tensors
    without a copy when the two zones share a device and a layout
    (zero-copy shared mapping); ``send_kv``/
    ``recv_kv`` carry per-request KV-cache rows for a prefill-cell ->
    decode-cell handoff; ``send_pages``/``poll_pages`` carry page stacks
    between decode replicas (``kind="pages"``): the disaggregated server
    (``serve/disagg.py``) and the cluster cache plane
    (``serve/cacheplane.py``) use them.
    """

    _ids = itertools.count()

    def __init__(self, src_cell, dst_cell, kind: str = "array"):
        self.cid = next(self._ids)
        self.src = src_cell
        self.dst = dst_cell
        self.kind = kind
        # (item, [(destination device, the CUDA event its copies end
        # with)])
        self._inbox: deque = deque()
        self.bytes_sent = 0
        self.transfers = 0
        self.seconds = 0.0
        self.open = True

    def _check_open(self):
        if not self.open:
            raise ChannelError("channel closed")

    def _shared_devices(self) -> bool:
        """Do the two zones share a device and, over a mesh, a layout
        (the same positions, so a tree laid out for one is laid out for
        the other)?"""
        src, dst = self.src.mesh, self.dst.mesh
        if src.size > 1 or dst.size > 1:
            return same_mesh(src, dst)
        return bool(set(self.src.devices) & set(self.dst.devices))

    def _place(self, tree: Any, target):
        """Copies of ``tree``'s tensors on ``target``: a device (default:
        the destination cell's), or ``(mesh, pspecs)``, a layout over a
        mesh (a mesh of one position is its device).  Returns (the tree,
        the destination devices)."""
        if target is None:
            dst_mesh = self.dst.mesh
            target = (dst_mesh, None) if dst_mesh.size > 1 else self.dst.device
        if isinstance(target, tuple):
            mesh, pspecs = target
            if mesh.size > 1:
                if pspecs is None:      # replicated on every position
                    out = tree_map(lambda t: relay_leaf(t, mesh, P(),
                                                        donate=False), tree)
                else:
                    out = tree_map(lambda t, s: relay_leaf(
                        t, mesh, s, donate=False), tree, pspecs)
                return out, mesh.distinct_devices()
            target = mesh.positions[0]
        device = torch.device(target)
        # a copy even on the sender's own device: the sender may reuse
        # its buffers (a page freed and refilled) once the copy is done
        return tree_map(lambda t: relay_leaf(t, device, donate=False),
                        tree), [device]

    def _transfer(self, tree: Any, target=None):
        """Enqueue the copies of ``tree`` onto ``target`` (see
        :meth:`_place`) and record the events they end with.
        ``seconds`` is the host's time to enqueue them; ``bytes`` the
        tree's logical bytes."""
        t0 = time.monotonic()
        out, devices = self._place(tree, target)
        events = []
        for device in devices:
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
                events.append((device, event))
        if not events:
            src = [t.device for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
            if src:         # a device-to-host copy: the host waits on it
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(src[0]))
                events.append((torch.device("cpu"), event))
        dt = time.monotonic() - t0
        nb = tree_bytes(out)
        self.bytes_sent += nb
        self.transfers += 1
        self.seconds += dt
        # per-transfer telemetry on the SENDING cell's recorder (the cell
        # whose devices sourced the bytes — exact attribution); page
        # migration (kind="pages") and weight fan-out land here too
        rec = recorder_of(getattr(self.src, "accounting", None))
        if rec.enabled:
            rec.add_complete(f"xfer:{self.kind}", t0, dt, bytes=nb,
                             dst=getattr(self.dst, "name", "?"))
            rec.record(f"xfer_{self.kind}_s", dt)
            rec.record(f"xfer_{self.kind}_bytes", nb)
        return out, events, {"bytes": nb, "seconds": dt,
                             "gbps": nb / max(dt, 1e-9) / 1e9}

    def send(self, tree: Any, target=None) -> dict:
        """Transfer a tensor tree to ``target``: a device, or ``(mesh,
        pspecs)`` (default: the destination cell's device, or every
        position of its mesh whole)."""
        self._check_open()
        out, events, stats = self._transfer(tree, target)
        self._inbox.append((out, events))
        return stats

    def send_kv(self, slot_cache: Any, target=None,
                *, meta: Optional[dict] = None) -> dict:
        """Stream one request's per-slot KV rows onto the decode cell's
        layout (the share-on-demand handoff).  ``slot_cache`` is a 1-row
        cache (``slice_cache_slots``); ``meta`` carries the request
        bookkeeping (rid, first token, ...)."""
        self._check_open()
        out, events, stats = self._transfer(slot_cache, target)
        self._inbox.append((KVEnvelope(meta=dict(meta or {}), cache=out),
                            events))
        return stats

    def send_pages(self, stacks: Any, target=None,
                   *, meta: Optional[dict] = None) -> dict:
        """Stream KV page stacks replica-to-replica (a canonical
        page-stack list as ``KVPool`` reads them out of its arena);
        ``meta`` carries the tree records / request bookkeeping needed to
        re-intern on the destination."""
        self._check_open()
        out, events, stats = self._transfer(stacks, target)
        self._inbox.append((KVEnvelope(meta=dict(meta or {}), cache=out),
                            events))
        return stats

    def poll_pages(self) -> Optional[KVEnvelope]:
        """Non-raising pop of the next in-flight page envelope."""
        return self.poll_kv()

    def map(self, tree: Any) -> dict:
        """Zero-copy publish (shared mapping analogue): the peer sees the
        same tensors.  Only valid when both zones share a device and, over
        a mesh, its positions."""
        self._check_open()
        if not self._shared_devices():
            raise ChannelError(
                f"map on channel {self.cid}: zones share no devices "
                "(zero-copy mapping needs co-located cells; use send())"
            )
        self._inbox.append((tree, []))
        self.transfers += 1
        return {"bytes": 0, "seconds": 0.0, "zero_copy": True}

    def recv(self) -> Any:
        """Pop the next item; the receiver's stream (the host, for a
        copy to the CPU) waits for its copies first."""
        self._check_open()
        if not self._inbox:
            raise ChannelError("empty channel")
        out, events = self._inbox.popleft()
        for device, event in events:
            if device.type == "cuda":
                torch.cuda.current_stream(device).wait_event(event)
            else:
                event.synchronize()
        return out

    def recv_kv(self) -> KVEnvelope:
        """Pop the next in-flight KV envelope (meta + per-slot cache)."""
        if self._inbox and not isinstance(self._inbox[0][0], KVEnvelope):
            raise ChannelError("head of channel is not a KV envelope")
        return self.recv()

    def poll_kv(self) -> Optional[KVEnvelope]:
        """Non-raising recv_kv: None when the channel is empty."""
        self._check_open()
        if not self._inbox:
            return None
        return self.recv_kv()

    def close(self):
        self.open = False
        self._inbox.clear()
