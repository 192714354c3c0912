"""Disaggregated serving under the supervisor daemon: autoscale + self-heal.

The twin of ``examples/serve_disagg.py``.  The paper's "isolate first,
then share on demand" applied to inference, with the management loop
CLOSED: a ClusterSpec names one prefill cell, a decode cell with
``replicas=2`` (bounded ``[2, 3]``), a ``kv`` ChannelSpec per replica, a
``tpot_p99`` SLOTarget and a ``ckpt_dir``.  One ``Supervisor.apply``
materializes all of it; from then on a :class:`SupervisorDaemon` tick —
interleaved with traffic via ``run_until_drained(on_step=daemon.tick)``
— does everything:

* **autoscale**: when the request queue backs up past the band derived
  from the declared SLO, the policy rewrites ``replicas`` and reconcile
  materializes a third decode cell, which ``DisaggServer.sync``
  live-attaches (KV channel + weight fan-out + fresh batcher);
* **self-heal**: killing a decode replica's column mid-traffic marks the
  cell failed; its in-flight requests requeue, reconcile re-carves the
  cell once the column is repaired, the declared ``ckpt_dir`` restores
  its params (no re-init, no fan-out), and sync re-attaches it — zero
  requests lost, zero manual primitive calls.

The grid is the example's, two rows of four columns, each entry a mesh
position on ``--device``: every cell (one column wide) lies over two
data rows, so the prefill cell's KV crosses into each replica's layout
and the weights fan out onto it.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_disagg
      [--device cpu] [--trace-out FILE] [--burst1 N --burst2 N --max-new N]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.core import (
    CellSpec,
    ChannelSpec,
    ClusterSpec,
    DeviceGrid,
    SLOTarget,
    Supervisor,
    SupervisorDaemon,
)
from repro_torch.device import resolve_device
from repro_torch.serve.batcher import Request
from repro_torch.serve.disagg import DisaggServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="export the run as Chrome trace-event JSON "
                         "(Perfetto-loadable), incl. the decision audit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--burst1", type=int, default=12,
                    help="requests of the burst that autoscales")
    ap.add_argument("--burst2", type=int, default=6,
                    help="requests of the burst a column failure meets")
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    grid = DeviceGrid.from_flat([device] * 8, pods=1, rows=2, cols=4)
    sup = Supervisor(grid)
    arch = smoke_config(get_arch("qwen3-4b"))
    ckpt_dir = tempfile.mkdtemp(prefix="decode-ckpt-")

    # -- desired state: prompts vs tokens; decode bounded [2,3] replicas,
    #    latency objective + checkpoint location declared, not scripted
    spec = ClusterSpec(
        cells=(CellSpec("prefill", arch, "serve", ncols=1),
               CellSpec("decode", arch, "serve", ncols=1, replicas=2,
                        min_replicas=2, max_replicas=3,
                        slo=SLOTarget(tpot_p99=0.25), ckpt_dir=ckpt_dir)),
        channels=(ChannelSpec("prefill", "decode", kind="kv"),),
    )
    plan = sup.apply(spec)
    print(f"applied spec -> plan [{plan.summary()}], epoch={sup.table.epoch}")
    zones = {n: (c.zone.pods, c.zone.c0, c.zone.c1, c.mesh.shape)
             for n, c in sup.cells.items()}
    decode_names = spec.cell("decode").instances()
    sup.cells[decode_names[0]].init_serve(
        generator=torch.Generator(device=device).manual_seed(0))

    # -- share on demand: weight fan-out + per-replica KV handoff channels
    srv = DisaggServer(sup, "prefill", decode_names,
                       batch_slots=2, max_len=64, chunk=16)
    channels = [(c.kind, c.src.name, c.dst.name) for c in sup.channels]
    print(f"channels: {[(k, s, '->', d) for k, s, d in channels]}")
    # checkpoint the params so recovery restores STATE, not just a zone
    ckpt.save(ckpt_dir, 0, sup.cells[decode_names[0]].serve_params)

    # -- the closed loop: health + reconcile + SLO autoscale + replica sync
    daemon = SupervisorDaemon(sup)
    daemon.attach_server(srv)
    daemon.add_slo_policy("decode", autoscale_replicas=True,
                          queue_depth=lambda: len(srv.pending),
                          queue_high=4, window=16, cooldown=0.0)

    rng = np.random.RandomState(0)

    def burst(n, rid0):
        for rid in range(rid0, rid0 + n):
            L = int(rng.randint(28, 52))
            srv.submit(Request(
                rid=rid, prompt=rng.randint(1, arch.vocab, size=L)
                .astype(np.int32), max_new_tokens=args.max_new))
        return rid0 + n

    # -- burst 1: the backlog crosses the SLO-derived band -> autoscale
    next_rid = burst(args.burst1, 0)
    srv.run_until_drained(on_step=daemon.tick)
    replicas_1 = len(srv.replicas)
    actions = [a["kind"] for p in daemon.policies for a in p.actions]
    print(f"burst 1 drained: {len(srv.done)}/{args.burst1} served, "
          f"replicas={replicas_1}, actions={actions}")

    # -- burst 2: kill a decode replica's column mid-traffic
    next_rid = burst(args.burst2, next_rid)
    for _ in range(2):
        srv.step()
        daemon.tick()
    victim = srv.replicas[1].cell
    pod, col = victim.zone.pods[0], victim.zone.c0
    affected = sup.fail_column(pod, col)
    print(f"killed column ({pod},{col}) -> affected={affected}")
    for _ in range(3):                     # daemon reaps + requeues; recover
        srv.step()                         # stays blocked while the column
        daemon.tick()                      # is quarantined
    sup.restore_column(pod, col)           # the repair arrives
    srv.run_until_drained(on_step=daemon.tick)
    done = {r.rid for r in srv.done}
    restored = [e for e in sup.events if e["op"] == "restore_ckpt"]
    print(f"burst 2 drained: all {next_rid} requests "
          f"done={done == set(range(next_rid))}, "
          f"requeued={srv.requeued}, replicas={len(srv.replicas)}")
    print(f"recovery restored from checkpoint: "
          f"{[(e['cell'], 'step ' + str(e['step'])) for e in restored]}")

    # -- the handoff in numbers: invocations, routing, channel traffic
    st = srv.stats()
    print(f"prefill invocations: {st['prefill_invocations']} (same-bucket "
          f"prompts batched)")
    print(f"decode invocations:  {st['decode_invocations']} across "
          f"{st['replicas']} replicas (requests per replica: "
          f"{st['per_replica_requests']})")
    print(f"kv channels: {st['kv_bytes'] / 1e6:.2f} MB over "
          f"{st['kv_transfers']} transfers in {st['kv_seconds'] * 1e3:.1f} ms")
    if st["paged_kv"]:
        print(f"kv pool: prefix hits {st['prefix_hit_tokens']} tok / misses "
              f"{st['prefix_miss_tokens']} tok, saved "
              f"{st['kv_bytes_saved'] / 1e6:.2f} MB, pages in use "
              f"{st['pages_in_use']} (evicted {st['pages_evicted']}, "
              f"occupancy {st['pool_occupancy']:.2f})")
    print(f"serving summary: {st['decode_serving']}")
    print(f"daemon: {daemon.ticks} ticks, "
          f"{sum(1 for r in daemon.history if r['plan'] != 'noop')} "
          f"non-noop plans")
    print(f"tail telemetry: "
          f"{ {k: round(v.get('p99', 0), 4) for k, v in st['telemetry'].items() if 'p99' in v} }")

    # -- the decision audit: WHY the daemon scaled / recovered / synced
    print("decision audit (scale/recover/sync):")
    for hit in daemon.audit.query():
        if any(k in hit["kind"] for k in
               ("grow", "shrink", "scale", "recover", "sync",
                "mark_failed", "destroy", "drain")):
            print(f"  tick {hit['tick']:3d}  {hit['kind']:<16} "
                  f"{hit.get('cell') or '-':<10} {hit.get('reason', '')}")

    # -- flight-recorder export: one span tree per request, audit folded
    #    in as instant events (must run BEFORE teardown drops the cells)
    if args.trace_out:
        trace = srv.trace_export(args.trace_out, daemon=daemon)
        print(f"trace: {len(trace['traceEvents'])} events "
              f"-> {args.trace_out} (open in Perfetto / chrome://tracing)")

    summary = {
        "plan": plan.summary(), "zones": zones, "channels": channels,
        "submitted": next_rid, "served": len(done),
        "lost": sorted(set(range(next_rid)) - done),
        "replicas_after_burst1": replicas_1, "actions": actions,
        "affected": affected, "requeued": srv.requeued,
        "restored": [(e["cell"], e["step"]) for e in restored],
        "replicas": len(srv.replicas), "kv_bytes": st["kv_bytes"],
        "kv_transfers": st["kv_transfers"],
        "events": [e["op"] for e in sup.events],
    }
    srv.close()
    # -- empty spec tears everything down
    sup.apply(ClusterSpec())
    print(f"cells after teardown: {list(sup.cells)}")
    print("done.")
    summary["cells_after_teardown"] = list(sup.cells)
    return summary


if __name__ == "__main__":
    main()
