"""Multi-host sharding of the pile stream (parallel/multihost.py)."""
