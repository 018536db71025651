"""Standing queries: registered once, answered incrementally (the port's
copy of ``inspektor_gadget_tpu/queries``).

spec.py — the registration grammar (alert-rule validation discipline);
cache.py — the digest-keyed result cache (exact invalidation);
engine.py — seal-tick incremental folds (two-stack sliding aggregation)
plus the process-wide live-engine registry the CLI reads.
"""

from .cache import ResultCache
from .engine import (SlidingFold, StandingQueryEngine, live_engines, live_stats, register,
                     unregister)
from .spec import (QUERY_SCHEMA, STATISTICS, QueryError, StandingQuery, load_queries,
                   load_queries_file)

__all__ = ["QUERY_SCHEMA", "STATISTICS", "QueryError", "ResultCache", "SlidingFold",
           "StandingQuery", "StandingQueryEngine", "live_engines", "live_stats",
           "load_queries", "load_queries_file", "register", "unregister"]
