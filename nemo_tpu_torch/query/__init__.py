"""Ad-hoc provenance queries, a port of the JAX package's ``query/``.

A small typed query language (:mod:`nemo_tpu_torch.query.lang`), a planner
lowering its patterns onto the frontier primitives of the sparse tier
(:mod:`nemo_tpu_torch.query.plan`), an executor draining one job per bucket
on the ``sparse_device`` lane (torch, kernel K2 for transitive hops) or the
``host`` lane with the result cache's two query tiers
(:mod:`nemo_tpu_torch.query.engine`), and the fixed pattern verbs as query
programs (:mod:`nemo_tpu_torch.query.verbs`).

Surfaces: ``python -m nemo_tpu_torch.cli query`` and ``POST /query`` of the
report server (``--serve``, also under ``--watch``).
"""

from __future__ import annotations

from nemo_tpu_torch.query.engine import execute_query, oracle_query, run_query_text
from nemo_tpu_torch.query.lang import Query, QueryError, parse_query
from nemo_tpu_torch.query.plan import QueryPlan, plan_query

__all__ = [
    "Query",
    "QueryError",
    "QueryPlan",
    "execute_query",
    "oracle_query",
    "parse_query",
    "plan_query",
    "run_query_text",
]
