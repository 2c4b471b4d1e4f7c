"""SIM1 vertical solver as a hand-written CUDA kernel (csrc/sim1.cu).

Replaces the Pallas TPU kernel fv3jedi_lm_tpu/ops/pallas_sim1.py
(`sim1_solver_pallas` :109, body `_sim1_kernel` :31), which serves the
nonhydrostatic trajectory step.  Same contract as core/nh_core.sim1_solver:
dm2/pt2/pm2/w2/dz2 (km, B), pem (km+1, B), ws (B,); returns
(pe (km+1, B), w2_new, dz2_new).

Bound: bytes.  Reading each input once and writing each output once moves
(9 km + 3) values a column; at the c96L72 shape (72, 62,424) in float32
that is 162 MB, 48.5 us at the H100's 3.35 TB/s (97 us in float64).  A
design with one thread per column walking device memory is bound by the
latency of its dependent loads instead, at about a tenth of that rate.
So the kernel stages tiles of columns in shared memory: a block copies
the (km, C) slices of its inputs in with cp.async, all in flight at once,
runs the level-parallel work on all its threads and the k-recurrences one
thread per column from shared memory, and stores the outputs coalesced.
The Thomas scratch (pp, gam) lives in shared memory, so the wrapper
allocates only the three outputs.  `plan` sizes the tile from km and the
dtype to fit the 227 KB of shared memory a block may take on sm_90.

Build: at first use, nvcc compiles csrc/sim1.cu for sm_90a into
`fv3jedi_lm_tpu_torch/build/libsim1_<hash>.so` (the hash covers the source
and the flags, so an edit rebuilds it); ctypes loads it.  A failed build
or launch raises.

Dispatch: a tensor on the CPU takes the plain `sim1_solver`; a CUDA tensor
launches the kernel or raises.  The kernel has no derivative: the
trajectory substep calls this wrapper, the differentiated (mixed) substep
calls the plain `sim1_solver` (core/nh_core._sim1), as the JAX package
does.  So an input that requires grad, or that carries a forward-mode
tangent (`torch.autograd.forward_ad` or `torch.func.jvp`), raises on either
device: the kernel would drop its derivative silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..constants import RGAS

_HERE = Path(__file__).resolve().parent.parent
_SRC = _HERE / "csrc" / "sim1.cu"
_BUILD = _HERE / "build"
#: -fmad=false: no multiply-add contraction, so the kernel rounds after
#: every operation exactly as the plain version's separate tensor ops do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
        if os.path.exists(path):
            cand = path
    if cand is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot "
                           "build the SIM1 CUDA kernel")
    return cand


def library_path() -> Path:
    """Where the shared library for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libsim1_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/sim1.cu into the build directory unless the library
    for this source already exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_double] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for name in ("sim1_solver_f32", "sim1_solver_f64"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


#: the most dynamic shared memory a block may take on sm_90 (227 KB)
SMEM_LIMIT = 232448
#: shared memory of one SM (228 KB), of which each resident block reserves 1 KB
_SM_SMEM, _SM_BLOCK_RESERVE = 233472, 1024
_TILES = (32, 16, 8)
_THREADS = 256
_DTYPES = (torch.float32, torch.float64)


def smem_bytes(km: int, tile: int, itemsize: int) -> int:
    """Shared memory of one block: 8 km + 2 values for each of its columns
    (six inputs, the pp and gam scratch; outputs reuse dead slots)."""
    return (8 * km + 2) * tile * itemsize


def plan(km: int, itemsize: int):
    """(tile, threads, smem bytes) for km levels of `itemsize`-byte values:
    the tile of 32, 16 or 8 columns that keeps the most columns resident on
    one SM, the larger on a tie.  Raises if not even 8 columns fit."""
    best = None
    for tile in _TILES:
        smem = smem_bytes(km, tile, itemsize)
        if smem > SMEM_LIMIT:
            continue
        blocks = min(_SM_SMEM // (smem + _SM_BLOCK_RESERVE), 2048 // _THREADS,
                     32)
        if best is None or blocks * tile > best[0]:
            best = (blocks * tile, (tile, _THREADS, smem))
    if best is None:
        raise ValueError(
            f"SIM1 kernel: km={km} levels of {itemsize}-byte values need "
            f"{smem_bytes(km, _TILES[-1], itemsize)} bytes of shared memory "
            f"for its smallest tile of {_TILES[-1]} columns, above the "
            f"{SMEM_LIMIT}-byte limit of a block on sm_90")
    return best[1]


def _differentiated(t) -> bool:
    """Whether `t` requires grad, carries a forward-mode tangent, or is
    wrapped by a torch.func transform (jvp, vjp, grad, vmap)."""
    if t.requires_grad:
        return True
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        return True
    return torch.autograd.forward_ad.unpack_dual(t).tangent is not None


def _check(dm2, pt2, pm2, pem, w2, dz2, ws):
    ins = (dm2, pt2, pm2, pem, w2, dz2, ws)
    if any(_differentiated(t) for t in ins):
        raise ValueError("sim1_solver_cuda is not differentiable: an input "
                         "requires grad or carries a tangent (the "
                         "differentiated substep uses nh_core.sim1_solver)")
    if dm2.ndim != 2:
        raise ValueError(f"dm2 must be (km, B), got {tuple(dm2.shape)}")
    km, B = dm2.shape
    if km < 2:
        raise ValueError(f"SIM1 needs km >= 2 levels, got {km}")
    if dm2.dtype not in _DTYPES:
        raise ValueError(f"sim1_solver_cuda: unsupported dtype {dm2.dtype}")
    want = {"dm2": (km, B), "pt2": (km, B), "pm2": (km, B),
            "pem": (km + 1, B), "w2": (km, B), "dz2": (km, B), "ws": (B,)}
    for (name, shape), t in zip(want.items(), ins):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != dm2.dtype:
            raise ValueError(f"{name}: dtype {t.dtype} != {dm2.dtype}")
        if t.device != dm2.device:
            raise ValueError(f"{name}: device {t.device} != {dm2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    plan(km, dm2.element_size())
    return km, B


def _launch(dt, ins, kappa, p_fac, tile=None, threads=None, mode=0):
    """Launch the kernel on CUDA tensors `ins` (checked by `_check`),
    counting the launch in `sim1_solver_cuda.launches`.  tile/threads
    override `plan`; mode 1 (copy in and out only) and 2 (solve a tile
    filled in shared memory) exist to time the two apart."""
    dm2 = ins[0]
    km, B = dm2.shape
    p_tile, p_threads, _ = plan(km, dm2.element_size())
    lib = _load()
    fn = lib.sim1_solver_f32 if dm2.dtype == torch.float32 else \
        lib.sim1_solver_f64
    pe = torch.empty((km + 1, B), dtype=dm2.dtype, device=dm2.device)
    w_new = torch.empty((km, B), dtype=dm2.dtype, device=dm2.device)
    dz_new = torch.empty((km, B), dtype=dm2.dtype, device=dm2.device)
    ptrs = [t.data_ptr() for t in (*ins, pe, w_new, dz_new)]
    # 16-byte copies need every row, and so every base, 16-byte aligned
    vec = int(B * dm2.element_size() % 16 == 0
              and all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(dm2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, km, B, float(dt), float(kappa), float(p_fac),
                 float(RGAS), tile or p_tile, threads or p_threads, vec, mode,
                 stream)
    if err != 0:
        raise RuntimeError(f"sim1 kernel launch failed: cudaError {err}")
    sim1_solver_cuda.launches += 1
    return pe, w_new, dz_new


def sim1_solver_cuda(dt, dm2, pt2, pm2, pem, w2, dz2, ws, kappa,
                     p_fac=0.05):
    """SIM1 with the contract of core/nh_core.sim1_solver; launches the
    CUDA kernel for CUDA tensors (counting the launch in
    `sim1_solver_cuda.launches`), takes the plain version for CPU
    tensors."""
    _check(dm2, pt2, pm2, pem, w2, dz2, ws)
    if dm2.device.type == "cpu":
        from ..core.nh_core import sim1_solver

        return sim1_solver(dt, dm2, pt2, pm2, pem, w2, dz2, ws, kappa, p_fac)
    if dm2.device.type != "cuda":
        raise ValueError(f"sim1_solver_cuda: unsupported device {dm2.device}")
    return _launch(dt, (dm2, pt2, pm2, pem, w2, dz2, ws), kappa, p_fac)


sim1_solver_cuda.launches = 0
