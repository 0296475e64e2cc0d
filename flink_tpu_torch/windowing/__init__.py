"""Windowing: slice-based and session assigners, lifecycle bookkeeping,
aggregates, fire projectors, and the session engine with its metadata
planes."""
