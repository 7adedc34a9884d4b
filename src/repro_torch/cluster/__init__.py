"""Multi-replica serving cluster of the port, copied from
``repro.cluster``: the layer that turns one engine or stream into a
service for "evergrowing user bases" (paper §1/§3).

    Router (dispatch policies)  ->  N x Transport (bounded inboxes)
      ^ admission control              thread replica (LocalTransport),
      ^ brownout, breakers             worker process (ProcessTransport) or
      v unified MetricsRegistry        TCP worker (SocketTransport), each
        (+ worker-side snapshots)      owning one backend: LM Engine |
                                       MARGOT stream | fn

Layering: ``repro_torch.core.service`` and the engine import the leaf
modules here (metrics, admission, tracing), so cluster modules must not
import ``repro_torch.core.service`` back — backends are passed in as
objects (``replica.StreamBackend``) or rebuilt from a serializable
``backends.BackendSpec`` inside worker processes.  Nothing here imports
torch at module import: a worker of a pure-Python backend never loads it.

Telemetry rides on ``Router.cluster_snapshot()``: a ``TelemetrySampler``
samples it into a ``TimeSeriesStore``, an ``SLOEngine`` turns windowed
burn rates into alerts (and into brownout pressure through
``Router.slo``), a ``StatsServer`` serves them over HTTP, and an
``Autoscaler`` adds and drains replicas under queue pressure.
"""
from repro_torch.cluster.admission import (AdmissionConfig,  # noqa: F401
                                           AdmissionController, Rejected,
                                           deadline_slack)
from repro_torch.cluster.artifacts import (ArtifactStore,  # noqa: F401
                                           artifact_ref, fetch_with_retry,
                                           resolve_spec, spec_fingerprint)
from repro_torch.cluster.autoscaler import (Autoscaler,  # noqa: F401
                                            AutoscalerConfig, ScaleEvent)
from repro_torch.cluster.backends import (BackendSpec,  # noqa: F401
                                          echo_spec, engine_spec,
                                          stream_spec)
from repro_torch.cluster.dashboard import (StatsServer,  # noqa: F401
                                           render_dash, render_watch)
from repro_torch.cluster.metrics import (Counter, Gauge,  # noqa: F401
                                         Histogram, MetricsRegistry,
                                         merge_snapshots)
from repro_torch.cluster.overload import (BreakerConfig,  # noqa: F401
                                          BrownoutConfig,
                                          BrownoutController,
                                          CircuitBreaker)
from repro_torch.cluster.replica import (ClusterRequest,  # noqa: F401
                                         EngineBackend, FnBackend,
                                         ReplicaConfig, ReplicaCrash,
                                         Status, StreamBackend, Terminal,
                                         WaitTimeout)
from repro_torch.cluster.router import POLICIES, Router  # noqa: F401
from repro_torch.cluster.slo import (BurnWindow, SLOEngine,  # noqa: F401
                                     SLOObjective, test_scaled_objective)
from repro_torch.cluster.timeseries import (EwmaRate,  # noqa: F401
                                            StageAttributor,
                                            TelemetrySampler,
                                            TimeSeriesStore)
from repro_torch.cluster.tracing import (FlightRecorder, Span,  # noqa: F401
                                         TraceContext, Tracer,
                                         current_recorder, current_tracer,
                                         prometheus_text, set_recorder,
                                         set_tracer, to_chrome_trace)
from repro_torch.cluster.transport import (TRANSPORTS,  # noqa: F401
                                           LocalTransport,
                                           ProcessTransport, ReplicaWorker,
                                           SocketTransport, Transport,
                                           default_flight_store,
                                           default_listener, make_transport,
                                           set_flight_store)
from repro_torch.cluster.wire import (PROTOCOL_VERSION,  # noqa: F401
                                      WorkerListener)
