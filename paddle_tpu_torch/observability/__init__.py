"""Metrics registry, run journal and spans (stdlib copies of the
reference's observability modules that the serving path calls)."""
from . import journal, metrics, spans

__all__ = ["journal", "metrics", "spans"]
