"""IFTS core: supervisor + cells (subOSes) + declarative specs + channels.

The names of the JAX package's ``repro.core``, less one: its
``collective_bytes`` parses HLO text, which the port has not; the port's
collectives record their bytes themselves
(``repro_torch.sharding.collectives.recording``).
"""
from repro_torch.core.partition import (  # noqa: F401
    DeviceGrid,
    PartitionError,
    PartitionTable,
    Zone,
    single_device_grid,
)
from repro_torch.core.cell import Cell, CellError  # noqa: F401
from repro_torch.core.spec import (  # noqa: F401
    CellSpec,
    ChannelSpec,
    ClusterSpec,
    SLOTarget,
    SpecError,
    TenantSpec,
)
from repro_torch.core.reconciler import Plan, PlanOp, Reconciler  # noqa: F401
from repro_torch.core.supervisor import Supervisor  # noqa: F401
from repro_torch.core.channels import (  # noqa: F401
    ArrayChannel,
    ChannelError,
    ControlPlane,
    KVEnvelope,
)
from repro_torch.core.elastic import ElasticPolicy, ReconcilePolicy  # noqa: F401
from repro_torch.core.daemon import SupervisorDaemon  # noqa: F401
from repro_torch.core.guard import BoundaryGuard, BoundaryViolation  # noqa: F401
from repro_torch.core.accounting import (  # noqa: F401
    CellAccounting,
    tenant_percentile,
)
from repro_torch.core.resharding import reshard_tree, tree_bytes  # noqa: F401
from repro_torch.core.telemetry import (  # noqa: F401
    DecisionAudit,
    EventLog,
    FlightRecorder,
    HistogramSketch,
    Span,
    TraceContext,
    chrome_trace,
    collect_traces,
)
