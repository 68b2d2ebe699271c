"""The posterior-alignment kernels: CUDA C++ for Hopper, bound with ctypes.

Two kernels, one per Pallas kernel of the JAX package:

  * csrc/banded_posterior.cu — the consensus aligner (band 128, gaps
    capped at 16), replacing pallas_align._kernel_banded;
  * csrc/full_posterior.cu — the stitch aligner (full width, exact
    gaps), replacing pallas_align._kernel.

Each source is built with nvcc for sm_90a into build/ at first use
(utils/build.py) and loaded with ctypes.  Kernels launch on PyTorch's
current stream; the wrappers allocate outputs and the hm staging
scratch with torch.empty and raise when the launch reports an error.

`posterior_summary` is the dispatcher the consensus and stitch paths
call: a CPU tensor takes the plain PyTorch version (ops/align.py), a
CUDA tensor launches the kernel, and a CUDA tensor of a shape the
kernel does not take raises.  It never falls back.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import threading
from typing import Dict, Optional

import torch

from consent_tpu_torch.ops import align as align_ops
from consent_tpu_torch.ops.align import PosteriorSummary, Scoring

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
KERNELS = {
    "banded_posterior": os.path.join(_CSRC, "banded_posterior.cu"),
    "full_posterior": os.path.join(_CSRC, "full_posterior.cu"),
}
# widest template the full-width kernel takes: 1,024 threads of up to 4
# columns each (csrc/full_posterior.cu, MAX_W)
FULL_MAX_W = 4096
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> str:
    """Compile one kernel's source (if not built yet); returns the
    shared library's path."""
    from consent_tpu_torch.utils.build import build_shared

    return build_shared(name, [KERNELS[name]], [[_nvcc(), *NVCC_FLAGS]])


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    path = build(name)
    lib = ctypes.CDLL(path)
    fn = getattr(lib, f"{name}_launch")
    fn.restype = _I
    if name == "banded_posterior":
        fn.argtypes = [_P] * 5 + [_I] * 9 + [_P] * 8
    else:
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_P] * 8
    with _lock:
        return _libs.setdefault(name, lib)


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


def _count(name: str) -> None:
    with _lock:
        _launches[name] += 1


def scan_window(max_hgap: int, width: int) -> int:
    """Columns the horizontal-gap max looks back over, as the plain
    version's doubling scan covers them: 2^ceil(log2(max_hgap)), capped
    at the row width; a window equal to the width is the exact prefix
    max (max_hgap = 0)."""
    if not max_hgap:
        return width
    return min(1 << math.ceil(math.log2(max_hgap)), width)


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _outputs(N: int, W: int, dev) -> tuple:
    opt = torch.empty((N,), dtype=torch.int32, device=dev)
    matched = torch.empty((N, W), dtype=torch.bool, device=dev)
    rest = [torch.empty((N, W), dtype=torch.int32, device=dev)
            for _ in range(4)]
    return opt, matched, *rest


def banded_posterior_summary(q, q_len, r, r_len, d0, sc: Scoring
                             ) -> PosteriorSummary:
    """Banded kernel (csrc/banded_posterior.cu) on CUDA tensors:
    q [N, Lq] uint8, r [N, W] uint8, q_len/r_len/d0 [N] int32."""
    N, Lq = q.shape
    W = r.shape[1]
    BW = sc.band
    if not (BW % 32 == 0 and 32 <= BW <= min(W, 1024)):
        raise ValueError(f"banded kernel takes bands that are multiples "
                         f"of 32 in [32, min(W, 1024)]; got {BW}, W={W}")
    for t, name, dt, shape in (
        (q, "q", torch.uint8, (N, Lq)), (r, "r", torch.uint8, (N, W)),
        (q_len, "q_len", torch.int32, (N,)),
        (r_len, "r_len", torch.int32, (N,)), (d0, "d0", torch.int32, (N,)),
    ):
        _check(t, name, dt, shape)
    outs = _outputs(N, W, q.device)
    if N == 0:
        return PosteriorSummary(*outs)
    hm = torch.empty((N, Lq, BW), dtype=torch.int16, device=q.device)
    fn = _lib("banded_posterior").banded_posterior_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), q_len.data_ptr(), r.data_ptr(),
                r_len.data_ptr(), d0.data_ptr(), N, Lq, W, BW, sc.match,
                sc.mismatch, sc.gap_open, sc.gap_extend,
                scan_window(sc.max_hgap, BW),
                *(t.data_ptr() for t in outs), hm.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"banded_posterior launch failed: CUDA error {rc}")
    _count("banded_posterior")
    return PosteriorSummary(*outs)


def full_posterior_summary(q, q_len, r, r_len, sc: Scoring
                           ) -> PosteriorSummary:
    """Full-width kernel (csrc/full_posterior.cu) on CUDA tensors:
    q [N, Lq] uint8, r [N, W] uint8 (1 <= W <= FULL_MAX_W),
    q_len/r_len [N] int32."""
    N, Lq = q.shape
    W = r.shape[1]
    if not 1 <= W <= FULL_MAX_W:
        raise ValueError(f"full-width kernel takes template widths in "
                         f"[1, {FULL_MAX_W}]; got {W}")
    for t, name, dt, shape in (
        (q, "q", torch.uint8, (N, Lq)), (r, "r", torch.uint8, (N, W)),
        (q_len, "q_len", torch.int32, (N,)),
        (r_len, "r_len", torch.int32, (N,)),
    ):
        _check(t, name, dt, shape)
    outs = _outputs(N, W, q.device)
    if N == 0:
        return PosteriorSummary(*outs)
    hm = torch.empty((N, Lq, W), dtype=torch.int16, device=q.device)
    fn = _lib("full_posterior").full_posterior_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), q_len.data_ptr(), r.data_ptr(),
                r_len.data_ptr(), N, Lq, W, sc.match, sc.mismatch,
                sc.gap_open, sc.gap_extend, scan_window(sc.max_hgap, W),
                *(t.data_ptr() for t in outs), hm.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"full_posterior launch failed: CUDA error {rc}")
    _count("full_posterior")
    return PosteriorSummary(*outs)


def posterior_summary(q, q_len, r, r_len, sc: Scoring,
                      d0: Optional[torch.Tensor] = None) -> PosteriorSummary:
    """The aligner dispatch of the consensus and stitch paths: the
    kernel for CUDA tensors (banded when sc.band), the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return align_ops.posterior_summary(q, q_len, r, r_len, sc, d0=d0)
    if not q.is_cuda:
        raise ValueError(f"no posterior aligner for device {q.device}")
    if sc.band:
        if d0 is None:
            d0 = torch.zeros(q.shape[:1], dtype=torch.int32, device=q.device)
        return banded_posterior_summary(q, q_len, r, r_len, d0, sc)
    return full_posterior_summary(q, q_len, r, r_len, sc)
