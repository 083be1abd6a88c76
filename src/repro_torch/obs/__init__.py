"""The port's instruments: spans and the tracer (:mod:`.trace`), the
Chrome/Perfetto and Prometheus exporters (:mod:`.export`), plan-vs-measured
attribution per span kind (:mod:`.attribution`), the roofline profile with
measured LARE (:mod:`.profile`), the SLO monitor (:mod:`.slo`) and workload
traces, scenarios and the open-loop replay (:mod:`.workload`).

    dep = Deployment.build(["jet_tagger", "tau_select"], trace=True)
    router = dep.serve()
    ...                                    # traffic
    dep.export_trace("trace.json")         # load in ui.perfetto.dev
    print(dep.format_attribution())        # planned-vs-measured per kind

or ``python -m repro_torch trace`` for the same from the command line.
"""

from repro_torch.obs.attribution import (AttributionRow, aggregate,
                                         attribution, format_attribution,
                                         reconcile)
from repro_torch.obs.export import (parse_prometheus, prometheus_text,
                                    to_chrome, write_chrome,
                                    write_prometheus)
from repro_torch.obs.profile import (PROFILE_KINDS, ProfileRow,
                                     format_profile, profile,
                                     roofline_terms, write_profile_snapshots)
from repro_torch.obs.slo import (PRIORITY_CLASSES, SloBudget, SloMonitor,
                                 SloViolation, priority_rank)
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer, percentile,
                                   summarize)
from repro_torch.obs.workload import (SCENARIOS, ReplayReport, RequestRecord,
                                      TraceRequest, format_replay, load_trace,
                                      make_scenario, replay, save_trace,
                                      smoke_trace, write_replay_snapshots)

__all__ = [
    "NULL_TRACER", "PRIORITY_CLASSES", "PROFILE_KINDS", "AttributionRow",
    "ProfileRow", "ReplayReport", "RequestRecord", "SCENARIOS", "SloBudget",
    "SloMonitor", "SloViolation", "Span", "TraceRequest", "Tracer",
    "aggregate", "attribution", "format_attribution", "format_profile",
    "format_replay", "load_trace", "make_scenario", "parse_prometheus",
    "percentile", "priority_rank", "profile", "prometheus_text",
    "reconcile", "replay", "roofline_terms", "save_trace", "smoke_trace",
    "summarize", "to_chrome", "write_chrome", "write_profile_snapshots",
    "write_prometheus", "write_replay_snapshots",
]
