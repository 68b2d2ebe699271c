"""Overlap detection: external minimap2 driver + native minimizer
overlapper (used when minimap2 isn't installed)."""
