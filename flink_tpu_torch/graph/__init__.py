"""The transformation DAG."""
