"""consent_tpu_torch — the PyTorch / CUDA port of consent_tpu.

Same pipeline, same bytes: overlaps -> piles -> windows -> batched
realign-vote consensus (device) -> k-mer / DBG repair (host C++) ->
stitch (device) -> corrected FASTA.  Plain tensor code is PyTorch; the
two posterior-alignment kernels are CUDA C++ written for Hopper
(csrc/), built with nvcc at first use.  Device entry points take an
explicit `device` ("cuda" by default) and raise when it is missing;
the CPU runs the kernels' plain PyTorch versions.

The package imports neither jax nor consent_tpu: host modules are
copies of the JAX package's, with only the package name changed.
"""

__version__ = "0.1.0"

from consent_tpu_torch.config import (
    ConsentConfig, correct_preset, from_reference, polish_preset,
)

__all__ = [
    "ConsentConfig",
    "correct_preset",
    "from_reference",
    "polish_preset",
    "__version__",
]
