"""Batched segment/scatter primitives."""
