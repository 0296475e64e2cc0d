"""Benchmark workloads."""
