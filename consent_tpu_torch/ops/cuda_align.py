"""The posterior-alignment kernels: CUDA C++ for Hopper, bound with ctypes.

Two kernels, one per Pallas kernel of the JAX package:

  * csrc/banded_posterior.cu — the consensus aligner (band 128, gaps
    capped at 16), replacing pallas_align._kernel_banded;
  * csrc/full_posterior.cu — the stitch aligner (full width, exact
    gaps), replacing pallas_align._kernel.

Shapes their register designs do not take — bands above 1,024, templates
wider than 16,384 columns — go to a third design both sources include,
csrc/posterior_tiled.cuh (one block per lane, the DP rows in global
scratch); banded_variant and full_variant pick the design by shape, and
its launches count under the kernel's name.

Each source is built with nvcc for sm_90a into build/ at first use
(utils/build.py) and loaded with ctypes.  Kernels launch on PyTorch's
current stream; the wrappers allocate outputs and the hm staging
scratch with torch.empty and raise when the launch reports an error.
They never synchronise or read a device value on the host, so a call
can be captured into a CUDA graph (ops/graphs.py); a launch made while
this thread captures is recorded (`recording`), not counted, and the
graph adds its recorded launches to the counts on every replay.

`posterior_summary` is the dispatcher the consensus and stitch paths
call: a CPU tensor takes the plain PyTorch version (ops/align.py), a
CUDA tensor launches the kernel, and a CUDA tensor of a shape the
kernel does not take raises.  It never falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import shutil
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from consent_tpu_torch.ops import align as align_ops
from consent_tpu_torch.ops.align import PosteriorSummary, Scoring

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
KERNELS = {
    "banded_posterior": os.path.join(_CSRC, "banded_posterior.cu"),
    "full_posterior": os.path.join(_CSRC, "full_posterior.cu"),
}
# the header both sources include (the one-block-per-lane tiled design)
TILED_HEADER = os.path.join(_CSRC, "posterior_tiled.cuh")
# widest template of the full-width kernel's register designs: 1,024
# threads of up to 16 columns each (csrc/full_posterior.cu, MAX_W); with
# exact gaps up to 1,024 columns it runs one warp per lane, otherwise one
# block per lane; wider templates run the tiled design
FULL_MAX_W = 16384
# bands the one-warp-per-lane banded kernel is instantiated for: 32, 64
# and every multiple of 128 up to 1,024 (1, 2, 4, 8, 12, ..., 32 slots
# per thread; csrc/banded_posterior.cu); wider multiples of 128 run the
# tiled design
BANDS = (32, 64) + tuple(range(128, 1025, 128))
# Most bytes of hm scratch one launch may stage.  The full-width
# kernel's scratch is N x (Lq + 32) x round_up(W, 128) int16: 0.88 GB at
# the stitch's widest main-path call (1,024 lanes of 640 x 640), which
# stays one launch, but 36 MB a lane at 4,224 x 4,224 and 0.54 GB a lane
# at 16,384 x 16,384.  Wider calls run in lane chunks of at most this
# much scratch, one after another on the stream, so a call's scratch
# (and a captured call's share of the graph pool) stays at 2 GiB, a
# fortieth of the card's 80 GB.  A lane that alone needs more runs in a
# chunk of its own, if the card has the memory free.
HM_BUDGET_BYTES = 2 << 30
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_tls = threading.local()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# launches by lane count N, per kernel
_lane_hist: Dict[str, Dict[int, int]] = {name: {} for name in KERNELS}
# launches made eagerly (a wrapper run outside `recording`), per kernel:
# no graph replay and no capture counts here
_eager: Dict[str, int] = {name: 0 for name in KERNELS}

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

    return build_shared(name, [KERNELS[name]], [[_nvcc(), *NVCC_FLAGS]],
                        deps=[TILED_HEADER])


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
    tiled = getattr(lib, f"{name}_tiled_launch")
    tiled.restype = _I
    tiled.argtypes = [_P] * 5 + [_I] * 10 + [_P] * 9
    with _lock:
        return _libs.setdefault(name, lib)


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def lane_histogram() -> Dict[str, Dict[int, int]]:
    """Launches of each kernel by lane count N, since the last reset."""
    with _lock:
        return {name: dict(sorted(h.items()))
                for name, h in _lane_hist.items()}


def eager_launch_counts() -> Dict[str, int]:
    """Launches each wrapper made eagerly since the last reset: outside
    a capture, and not as part of a graph's replay."""
    with _lock:
        return dict(_eager)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0
            _eager[name] = 0
            _lane_hist[name].clear()


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, int]]]:
    """Launches this thread makes inside the block go to the yielded
    list as (kernel, lanes) and not to the counts: a graph capture
    launches nothing, its replays do (add_launches)."""
    rec: List[Tuple[str, int]] = []
    prev = getattr(_tls, "record", None)
    _tls.record = rec
    try:
        yield rec
    finally:
        _tls.record = prev


def add_launches(launches: Sequence[Tuple[str, int]]) -> None:
    """Count launches made by a replay of a captured graph."""
    with _lock:
        for name, lanes in launches:
            _launches[name] += 1
            hist = _lane_hist[name]
            hist[lanes] = hist.get(lanes, 0) + 1


def _count(name: str, lanes: int) -> None:
    rec = getattr(_tls, "record", None)
    if rec is not None:
        rec.append((name, lanes))
        return
    add_launches([(name, lanes)])
    with _lock:
        _eager[name] += 1


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


def banded_variant(band: int, W: int) -> str:
    """The design the banded kernel runs a band in, as the JAX package's
    rule admits bands (32, 64, or a multiple of 128, up to the template
    width W): "warp" (one warp per lane, band / 32 slots a thread) for
    BANDS, "tiled" (csrc/posterior_tiled.cuh) for wider multiples of
    128.  Raises ValueError for any other band."""
    if band > W or not (band in BANDS or (band > BANDS[-1]
                                           and band % 128 == 0)):
        raise ValueError(f"banded kernel takes bands of 32, 64 or a "
                         f"multiple of 128, up to the template width; got "
                         f"{band}, W={W}")
    return "warp" if band in BANDS else "tiled"


def banded_posterior_summary(q, q_len, r, r_len, d0, sc: Scoring
                             ) -> PosteriorSummary:
    """Banded kernel (csrc/banded_posterior.cu) on CUDA tensors:
    q [N, Lq] uint8 (Lq >= 1), r [N, W] uint8, q_len/r_len/d0 [N] int32,
    bases coded 0-3.  The band is 32, 64 or a multiple of 128, up to W:
    one warp per lane, band / 32 slots per thread, up to 1,024; the
    tiled design above (banded_variant)."""
    N, Lq = q.shape
    W = r.shape[1]
    BW = sc.band
    variant = banded_variant(BW, W)
    if Lq < 1:
        raise ValueError("banded kernel takes query rows of >= 1 base")
    for t, name, dt, shape in (
        (q, "q", torch.uint8, (N, Lq)), (r, "r", torch.uint8, (N, W)),
        (q_len, "q_len", torch.int32, (N,)),
        (r_len, "r_len", torch.int32, (N,)), (d0, "d0", torch.int32, (N,)),
    ):
        _check(t, name, dt, shape)
    if variant == "tiled":
        return _tiled_summary("banded_posterior", q, q_len, r, r_len, d0, sc)
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
    _count("banded_posterior", N)
    return PosteriorSummary(*outs)


def full_stage_cols(W: int) -> int:
    """Columns of one slot of the full-width kernel's hm scratch: W
    rounded up to 128 (32 threads x C columns, C a multiple of 4, in the
    one-warp-per-lane kernel; csrc/full_posterior.cu: stage_cols)."""
    return (W + 127) // 128 * 128


def full_stage_slots(Lq: int) -> int:
    """Slots of the full-width kernel's hm scratch per lane: one per
    step of the one-warp-per-lane kernel's wavefront (q_len + 31 steps),
    one per row in the one-block-per-lane kernel."""
    return Lq + 32


def full_hm_lane_bytes(Lq: int, W: int) -> int:
    """Bytes of the full-width kernel's hm scratch for one lane (the
    tiled design's above FULL_MAX_W columns)."""
    if W > FULL_MAX_W:
        return tiled_lane_bytes(Lq, W)
    return full_stage_slots(Lq) * full_stage_cols(W) * 2


def tiled_lane_bytes(Lq: int, W: int) -> int:
    """Scratch of the tiled design for one lane: hm [Lq, W] int16 and
    four int32 rows of W."""
    return Lq * W * 2 + 4 * W * 4


def lane_chunks(N: int, per_lane: int, free_bytes: Optional[int] = None,
                card: str = "the card") -> List[Tuple[int, int]]:
    """The lane ranges [lo, hi) one call launches, in order: they cover
    [0, N) once, each with at most HM_BUDGET_BYTES of scratch, or one
    lane alone where a lane needs more.  free_bytes, when given, is the
    memory the card can still hand out: a lane that needs more than the
    budget and more than that raises, naming the card's memory."""
    if per_lane > HM_BUDGET_BYTES:
        if free_bytes is not None and per_lane > free_bytes:
            raise ValueError(
                f"one lane needs {per_lane} bytes of hm scratch, above "
                f"HM_BUDGET_BYTES ({HM_BUDGET_BYTES}) and above the "
                f"{free_bytes} bytes {card} has free")
        step = 1
    else:
        step = HM_BUDGET_BYTES // max(per_lane, 1)
    return [(lo, min(lo + step, N)) for lo in range(0, N, step)]


def full_lane_chunks(N: int, Lq: int, W: int,
                     free_bytes: Optional[int] = None,
                     card: str = "the card") -> List[Tuple[int, int]]:
    """The lane ranges one full-width call launches (lane_chunks over
    full_hm_lane_bytes)."""
    return lane_chunks(N, full_hm_lane_bytes(Lq, W), free_bytes, card)


def _card_memory(dev, per_lane: int) -> Tuple[Optional[int], str]:
    """(bytes the card can still hand out, its name and size) when one
    lane's scratch exceeds the budget; (None, "") otherwise (no query)."""
    if per_lane <= HM_BUDGET_BYTES:
        return None, ""
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return free + cached, (f"{torch.cuda.get_device_name(dev)} "
                           f"({total} bytes)")


def full_variant(W: int, sc: Scoring) -> str:
    """The design the full-width kernel runs a call in, as
    full_posterior_launch picks it: "warp" (one warp per lane) for exact
    gaps up to 1,024 columns with gap scores its int16 columns take,
    "block" (one block per lane) for the rest up to FULL_MAX_W columns,
    "tiled" (csrc/posterior_tiled.cuh) above."""
    if W < 1:
        raise ValueError(f"full-width kernel takes template widths >= 1; "
                         f"got {W}")
    if W > FULL_MAX_W:
        return "tiled"
    if (W <= 1024 and scan_window(sc.max_hgap, W) >= W and sc.gap_open > 0
            and sc.gap_extend >= 0 and W * sc.gap_extend < (1 << 13)):
        return "warp"
    return "block"


def full_posterior_summary(q, q_len, r, r_len, sc: Scoring
                           ) -> PosteriorSummary:
    """Full-width kernel (csrc/full_posterior.cu) on CUDA tensors:
    q [N, Lq] uint8, r [N, W] uint8 (W >= 1), q_len/r_len [N] int32.
    One warp per lane up to 1,024 columns, one block per lane above, the
    tiled design past FULL_MAX_W (full_variant); lanes launch in chunks
    (full_lane_chunks) that share one hm scratch, in order on the
    current stream."""
    N, Lq = q.shape
    W = r.shape[1]
    if full_variant(W, sc) == "tiled":
        return _tiled_summary("full_posterior", q, q_len, r, r_len, None, sc)
    for t, name, dt, shape in (
        (q, "q", torch.uint8, (N, Lq)), (r, "r", torch.uint8, (N, W)),
        (q_len, "q_len", torch.int32, (N,)),
        (r_len, "r_len", torch.int32, (N,)),
    ):
        _check(t, name, dt, shape)
    outs = _outputs(N, W, q.device)
    if N == 0:
        return PosteriorSummary(*outs)
    chunks = full_lane_chunks(
        N, Lq, W, *_card_memory(q.device, full_hm_lane_bytes(Lq, W)))
    hm = torch.empty((max(hi - lo for lo, hi in chunks),
                      full_stage_slots(Lq), full_stage_cols(W)),
                     dtype=torch.int16, device=q.device)
    fn = _lib("full_posterior").full_posterior_launch
    window = scan_window(sc.max_hgap, W)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for lo, hi in chunks:
            # lane lo's row of every [N, ...] tensor
            rc = fn(*(_row(t, lo) for t in (q, q_len, r, r_len)),
                    hi - lo, Lq, W, sc.match, sc.mismatch, sc.gap_open,
                    sc.gap_extend, window,
                    *(_row(t, lo) for t in outs),
                    hm.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"full_posterior launch failed: CUDA error {rc}")
            _count("full_posterior", hi - lo)
    return PosteriorSummary(*outs)


def _row(t: torch.Tensor, lo: int) -> int:
    """Address of lane lo's row of an [N, ...] tensor."""
    return t.data_ptr() + lo * t.stride(0) * t.element_size()


def _tiled_summary(name, q, q_len, r, r_len, d0, sc: Scoring
                   ) -> PosteriorSummary:
    """The tiled design (csrc/posterior_tiled.cuh) of kernel `name` on
    CUDA tensors: one block per lane, lanes in chunks of at most
    HM_BUDGET_BYTES of scratch (one lane alone where it needs more), in
    order on the current stream.  The gap window follows the plain
    version's rule over the whole row: its doubling scan when
    0 < max_hgap < W, the exact prefix max otherwise."""
    N, Lq = q.shape
    W = r.shape[1]
    checks = [(q, "q", torch.uint8, (N, Lq)), (r, "r", torch.uint8, (N, W)),
              (q_len, "q_len", torch.int32, (N,)),
              (r_len, "r_len", torch.int32, (N,))]
    if d0 is not None:
        checks.append((d0, "d0", torch.int32, (N,)))
    for t, tname, dt, shape in checks:
        _check(t, tname, dt, shape)
    outs = _outputs(N, W, q.device)
    if N == 0:
        return PosteriorSummary(*outs)
    per = tiled_lane_bytes(Lq, W)
    chunks = lane_chunks(N, per, *_card_memory(q.device, per))
    m = max(hi - lo for lo, hi in chunks)
    hm = torch.empty((m, Lq, W), dtype=torch.int16, device=q.device)
    rows = torch.empty((m, 4, W), dtype=torch.int32, device=q.device)
    capped = bool(sc.max_hgap) and sc.max_hgap < W
    window = scan_window(sc.max_hgap, W) if capped else W
    fn = getattr(_lib(name), f"{name}_tiled_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for lo, hi in chunks:
            rc = fn(*(_row(t, lo) for t in (q, q_len, r, r_len)),
                    None if d0 is None else _row(d0, lo),
                    hi - lo, Lq, W, sc.band, sc.match, sc.mismatch,
                    sc.gap_open, sc.gap_extend, window, int(capped),
                    *(_row(t, lo) for t in outs),
                    hm.data_ptr(), rows.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"{name} (tiled) launch failed: CUDA error {rc}")
            _count(name, hi - lo)
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
