"""Simulation and evaluation utilities (test data generation, identity
metrics) — the reference ships only a bundled example (README.md:49-63);
we generate ground-truthed data instead."""
