"""Core types: records, configuration, type information, device choice."""
