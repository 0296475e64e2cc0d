"""Windowing: slice-based assigners, lifecycle bookkeeping, aggregates and
fire projectors."""
