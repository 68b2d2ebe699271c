"""Observability and misc utilities."""
