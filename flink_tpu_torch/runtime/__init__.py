"""Operators, watermarks and deferred fire results."""
