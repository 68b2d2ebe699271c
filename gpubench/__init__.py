"""The benchmark of consent_tpu_torch on NVIDIA cards (see run.py)."""
