"""Keyed state: key groups and the host slot index."""
