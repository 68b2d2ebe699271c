"""Frozen copies of the port's plain code, for the reference (README.md
says where each comes from and what was changed)."""
