"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the SIM1 CUDA kernel from fv3jedi_lm_tpu_torch/csrc/sim1.cu,
checks it against its plain PyTorch version on the card at the shapes of
tests/test_torch_cuda.py and times it (with its copy-only and solve-only
parts, and the tile sizes around its plan), checks the bit-packed branch
tapes on the card against the CPU's, checks the port on the GPU against
the port on the CPU at a small size, runs the nonhydrostatic trajectory
step (LinearModel.run_nl) at c96L72 float32, checks that every SIM1 call
of that run went through the kernel, and profiles one more step to find
the kernel's launches in the trace.  Then the main path, the
tangent-linear and adjoint pair (LinearModel.step_tl + step_ad): on the
GPU against the CPU at c12L10 float64, hydrostatic and nonhydrostatic,
with the dot-product identity and SIM1's launches by mode; timed at
c96L72 float32 hydrostatic (the bench.py configuration); and one warm
pair under torch.profiler.  Then the same pair with the GEOS physics on
(boundary-layer turbulence and RAS/cloud moist physics): on the GPU
against the CPU at c8L12 float64, moist modes 1 and 2 with the
turbulence, with the dot-product identity; timed at c96L72 float32
hydrostatic with moist mode 1 and the turbulence on a convective
sounding; and one warm pair under torch.profiler with the physics' own
scopes.  Then the rest of the dynamics options: each one on its own on
the GPU against the CPU at c12L10 float64 (step_nl, step_tl, step_ad,
the identity; the nonhydrostatic beta case launches SIM1), and the
4D-Var window (run_nl, run_tl, run_ad) at c96L72 float32 with the
options FV3 configurations commonly turn on, with and without the
saveltraj cache and the host timers' table.  Then the decomposition
(fv3jedi_lm_tpu_torch/parallel/faces.py) laid out as the JAX package's
device mesh, (face, y, x) tiles, the ranks sharing the card over gloo
(NCCL needs one GPU per rank): at c12 and c8 in float64, in the layouts
(6, 1, 1) and (2, 2, 2), each exchange and g_sum against one process,
step_nl, step_tl and step_ad hydrostatic and nonhydrostatic (SIM1
launched on every nonhydrostatic rank), and on (2, 2, 2) the physics
pair and the window, against one process on the card; and the c96L72
pair with the physics on eight ranks (2, 2, 2) against the single
process's pair on the same inputs, timed, with each rank's exchanges,
bytes, peak memory and SIM1 launches (none, hydrostatic).  Each c96L72
phase prints the bytes of its cached trajectories (checkpoints, bool
tapes, integer tapes) and, once its model is dropped, checks that the
device memory came back (no cyclic collection is run).  Each phase
raises on failure.  Every spawn of ranks ends before one deadline,
DEADLINE_S after the start, so a rank that hangs fails its phase by
name.  The end of each phase is printed as a "[time]" line.  The last
two lines of standard output are a JSON line describing the kernels
and a JSON status line.  Without a CUDA device the script exits
non-zero and prints no result.  It imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: c12L10 nonhydrostatic, the configuration of tests/test_torch_step_nl.py
SMALL_KW = dict(npx=13, npy=13, npz=10, n_split=2, k_split=1,
                d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=3, hydrostatic=False)
#: c96L72 nonhydrostatic float32, the NH rung of bench.py (bench.py:174-180)
FULL_KW = dict(npx=97, npy=97, npz=72, n_split=6, k_split=1,
               d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=6, hydrostatic=False,
               dtype="float32")
FULL_DT = 900.0
#: c12L10 float64 of the TL/AD check: tests/test_lm.py DYN_KW (hydrostatic)
#: and tests/test_nh_e2e.py NH_KW (nonhydrostatic)
TLAD_SMALL = {
    "hydrostatic": dict(npx=13, npy=13, npz=10, n_split=2, k_split=1,
                        d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=3,
                        n_sponge_pert=4, d2_bg_k1_pert=0.2,
                        d2_bg_k2_pert=0.1, d2_bg_ks_pert=0.1),
    "nonhydrostatic": dict(npx=13, npy=13, npz=10, n_split=2, k_split=1,
                           d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=3,
                           n_sponge_pert=4, d2_bg_k1_pert=0.2,
                           d2_bg_k2_pert=0.1, d2_bg_ks_pert=0.1,
                           hydrostatic=False),
}
#: c96L72 hydrostatic float32, the configuration of bench.py's TL+AD
#: metric (bench.py:174-180); the DynConfig defaults give the split
#: linearization (pert hord 2, kord 17, pert sponge, vorticity damping)
TLAD_FULL_KW = dict(npx=97, npy=97, npz=72, n_split=6, k_split=1,
                    d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=6, dtype="float32")
#: the options of phase_options_small, each on its own over the c12L10
#: hydrostatic configuration of TLAD_SMALL (the JAX package's tests of
#: each: tests/test_energetics.py, test_beta.py, test_rayleigh.py,
#: test_mix_dp.py, test_omega.py)
OPTIONS_SMALL = {
    "consv_te": dict(consv_te=1.0),
    "beta": dict(beta=0.4),
    "beta_nh": dict(beta=0.4, hydrostatic=False),
    "d_con": dict(d_con=1.0, do_vort_damp=True, vtdm4=0.05),
    "d_ext": dict(d_ext=0.02),
    "rayleigh_super": dict(tau=5.0, rf_cutoff=50.0e2),
    "rayleigh_friction": dict(tau=5.0, rf_cutoff=50.0e2, grid_type=4),
    "rayleigh_fast": dict(tau=5.0, rf_cutoff=50.0e2, rayleigh_fast=True),
    "fill_dp": dict(fill_dp=True),
    "hord10_kord9": dict(hord_mt=10, hord_vt=10, hord_tm=10, hord_dp=10,
                         kord_mt=9, kord_tm=9, kord_tr=9),
    "trdm2": dict(nord_tr=1, trdm2=0.1),
    "omega": dict(compute_omega=True),
}
#: the options FV3 configurations commonly turn on (the energy-conserving
#: remap, dissipative heating, Rayleigh damping, the monotone hord 10 and
#: kord 9, thin-layer filling), for the c96L72 window; with the vorticity
#: damping, without which d_con heats only the top two levels, where the
#: sponge sets it to 0 (core/dyn_core._n_con)
PRODUCTION_OPTIONS = dict(hord_mt=10, hord_vt=10, hord_tm=10, hord_dp=10,
                          kord_mt=9, kord_tm=9, kord_tr=9, d_con=1.0,
                          consv_te=1.0, tau=5.0, fill_dp=True,
                          do_vort_damp=True, vtdm4=0.05)
WINDOW_NT = 3
#: the window's configuration: TLAD_FULL_KW with the perturbation sponge
#: at production magnitudes (tests/test_sponge_depth.py).  TLAD_FULL_KW
#: keeps the DynConfig defaults d2_bg_k1/k2/ks_pert = 4, 2, 2, with which
#: an explicit del-2 is unstable: its TL grows by about 1e8 a step, so a
#: window of 3 steps overflows float32 in the adjoint
#: (scripts/torch_tl_growth.py)
WINDOW_KW = dict(TLAD_FULL_KW, d2_bg_k1_pert=0.2, d2_bg_k2_pert=0.12,
                 d2_bg_ks_pert=0.06)
#: the perturbation scales of tests/test_lm.py, tests/test_nh_e2e.py and
#: tests/test_moist.py `_rand_pert`
PERT_SCALE = dict(u=1.0, v=1.0, t=1.0, delp=10.0, qv=1e-4, ql=1e-6,
                  qi=1e-6, o3=1e-7, w=0.1, delz=1.0, cfcn=1e-3)
#: c8L12 float64 of the physics check: tests/test_moist.py's configuration
#: and its troposphere-heavy hybrid coordinate (only the top 2 interfaces
#: above 30 hPa, so deep convection is geometrically possible)
PHYS_SMALL_KW = dict(npx=9, npy=9, npz=12, n_split=1, k_split=1,
                     d2_bg_k1=0.2, d2_bg_k2=0.1, n_sponge=2,
                     n_sponge_pert=3, d2_bg_k1_pert=0.2, d2_bg_k2_pert=0.1,
                     d2_bg_ks_pert=0.1)
PHYS_PREF = np.array([30., 1500., 4000., 8000., 14000., 22000., 32000.,
                      44000., 57000., 71000., 85000., 93000., 100000.])
PHYS_BK = np.clip((PHYS_PREF - 20000.0) / (1.0e5 - 20000.0), 0.0, 1.0)
PHYS_AK = PHYS_PREF - PHYS_BK * 1.0e5
#: SIM1 at c96L72: 72 levels, 6 faces of 102 x 102 padded columns
KM, B_FULL = 72, 6 * 102 * 102
#: (dtype, km, B) of the kernel check, as tests/test_torch_cuda.py
KERNEL_CASES = ([("float32", KM, B_FULL), ("float32", KM, 4096),
                 ("float64", 12, 200)]
                + [(dtype, km, ncol) for dtype in ("float32", "float64")
                   for km in (2, 10, 72, 127) for ncol in (1004, 1001, 5)])
#: floating-point operations of SIM1 per level of a column, counting each
#: +, -, *, /, max, exp and log of core/nh_core.sim1_solver once
SIM1_OPS_PER_LEVEL = 62
#: one H100 SXM (NVIDIA's data sheet): HBM rate, float32 rate outside the
#: tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return name, smi.splitlines()[0]


def _sim1_inputs(km, ncol, seed, dtype, device):
    """Random but physical column inputs (as tests/test_torch_cuda.py)."""
    from fv3jedi_lm_tpu_torch.constants import GRAV, RGAS

    rng = np.random.default_rng(seed)
    pe_ref = np.linspace(100.0, 1.0e5, km + 1)
    dm2 = np.repeat((pe_ref[1:] - pe_ref[:-1])[:, None], ncol, 1)
    dm2 *= 1.0 + 0.05 * rng.random((km, ncol))
    pt2 = 250.0 + 30.0 * rng.random((km, ncol))
    pm2 = np.repeat((0.5 * (pe_ref[1:] + pe_ref[:-1]))[:, None], ncol, 1)
    pem = np.repeat(pe_ref[:, None], ncol, 1)
    dz2 = -(dm2 / GRAV) * RGAS * pt2 / pm2 * (
        1.0 + 0.02 * rng.random((km, ncol)))
    w2 = 0.5 * rng.standard_normal((km, ncol))
    ws = 0.1 * rng.standard_normal(ncol)
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (dm2, pt2, pm2, pem, w2, dz2, ws))


def _time_ms(fn, batches=7, batch=20):
    """Device time of one fn() call by CUDA events around `batch`
    back-to-back calls, median over `batches`: the host's cost of issuing
    a call is hidden behind the device's work when it is the smaller."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / batch)
    return float(np.median(ts))


def _time_single_ms(fn, n=25):
    """Median of n single calls, each between its own CUDA events (how the
    first CUDA version of SIM1 was timed): includes the host's issue time
    where it exceeds the device's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def sim1_bound_ms(km, ncol, itemsize):
    """The least time one H100 could take for SIM1 on (km, ncol) columns,
    and what bounds it: each input read once ((6 km + 2) values a column)
    and each output written once ((3 km + 1)) at the HBM rate, against
    SIM1_OPS_PER_LEVEL operations per level at the float32 rate."""
    byte_s = (9 * km + 3) * ncol * itemsize / HBM_BYTES_PER_S
    ops_s = SIM1_OPS_PER_LEVEL * km * ncol / F32_OPS_PER_S
    return 1e3 * max(byte_s, ops_s), ("bytes" if byte_s >= ops_s
                                      else "operations")


#: device memory a dropped model may leave allocated (the halo index and
#: table caches, kept per device)
MEMORY_SLACK = 64 * 2**20


def _allocated():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def memory_returned(what, before, card):
    """Checks that torch.cuda.memory_allocated() is back within
    MEMORY_SLACK of `before`, its value before the model of `what` was
    made, now that the model and everything of it are dropped (no cyclic
    collection: a model frees its device memory at `del`)."""
    torch.cuda.synchronize()
    now = torch.cuda.memory_allocated()
    print(f"[memory] {what}: {now} B allocated after the model was dropped, "
          f"{before} B before it was made ({(now - before) / 2**20:+.3f} MiB) "
          f"({card[0]}; {card[1]})", flush=True)
    if now > before + MEMORY_SLACK:
        raise AssertionError(
            f"{what}: {(now - before) / 2**20:.1f} MiB of device memory "
            "outlived the dropped model")


def unpacked_decisions(tape):
    """Boolean decisions of ndim > 0 (per row) that `tape` stores
    unpacked: 0 when every such decision is bit-packed."""
    from fv3jedi_lm_tpu_torch.core.freeze import leaves

    return sum(e.numel() for e, lead in leaves(tape)
               if isinstance(e, torch.Tensor) and e.dtype == torch.bool
               and e.dim() > lead)


def print_cached(tag, lm, card):
    """Prints the bytes of each cached trajectory of `lm`, split as
    debug.cache_bytes splits them (checkpoints, the dynamics tapes'
    boolean and integer decisions, the moist linearization and its tape,
    the turbulence coefficients); fails if a boolean decision of ndim > 0
    is stored unpacked.  Returns debug.cache_bytes(lm)."""
    from fv3jedi_lm_tpu_torch import debug

    cached = debug.cache_bytes(lm)
    gib = lambda n: f"{n} B ({n / 2**30:.3f} GiB)"
    for i, c in enumerate(cached):
        tapes = c.tape_bool + c.tape_int + c.moist_bool + c.moist_int
        msg = (f"[{tag}] cached trajectory {i}: checkpoints {gib(c.ckpts)}, "
               f"bool tapes {gib(c.tape_bool)}, integer tapes "
               f"{gib(c.tape_int)}")
        if c.moist or c.turb:
            msg += (f", moist ltraj {gib(c.moist)}, moist bool tape "
                    f"{gib(c.moist_bool)}, moist integer tape "
                    f"{gib(c.moist_int)}, turbulence ltraj {gib(c.turb)}")
        print(msg + f"; total {gib(c.total)}, tapes "
              f"{100 * tapes / max(c.total, 1):.1f} % of it "
              f"({card[0]}; {card[1]})", flush=True)
    for _, (_, (_, tapes, mpack, _)) in lm._traj_cache.items():
        every = ([t for sub in tapes["sub"] for t3 in sub for t in t3]
                 + list(tapes["post"]) + ([mpack[1]] if mpack else []))
        raw = sum(unpacked_decisions(t) for t in every)
        if raw:
            raise AssertionError(f"{tag}: {raw} boolean decisions of ndim > "
                                 "0 stored unpacked")
    return cached


def tape_storage(device):
    """The tape storage of core/freeze.py on `device` against the CPU's:
    boolean decisions of sizes that are and are not multiples of 8, an
    fscan entry of 6 rows and qsat's table index (dqsat), recorded on
    both.  The stored bytes must be equal, the replay on `device` must
    give the recorded decisions, and the table index must be uint16, 2
    bytes a value.  Returns (packed bool bytes, decisions they hold,
    (index dtype, bytes per value))."""
    from fv3jedi_lm_tpu_torch.core import freeze
    from fv3jedi_lm_tpu_torch.physics.qsat import dqsat

    rng = np.random.default_rng(23)
    preds = [rng.random(shape) > 0.5
             for shape in ((7,), (16,), (5, 9), (72, 13, 11))]
    xs = rng.standard_normal((6, 3, 5))
    temp = np.linspace(150.0, 330.0, 101)
    pres = np.linspace(1.0e3, 1.0e5, 101)

    def run(dev, flip):
        as_t = lambda a: torch.as_tensor(a, device=dev)
        got = [freeze.fbool(as_t(~p if flip else p)) for p in preds]
        freeze.fscan(lambda c, x: (c + freeze.fmax(x, 0.0), None),
                     as_t(np.zeros((3, 5))), as_t(-xs if flip else xs))
        dqsat(as_t(temp), as_t(pres))
        return got

    tapes = {}
    for dev in (device, "cpu"):
        with freeze.recording() as tapes[dev]:
            run(dev, False)
    got = list(freeze.leaves(tapes[device]))
    want = list(freeze.leaves(tapes["cpu"]))
    if len(got) != len(want):
        raise AssertionError(f"tapes: {len(got)} entries on {device}, "
                             f"{len(want)} on the CPU")
    nbool = nbits = 0
    index = None
    for (g, _), (w, _) in zip(got, want):
        if isinstance(w, freeze.Packed):
            if not (isinstance(g, freeze.Packed) and g.shape == w.shape
                    and torch.equal(g.data.cpu(), w.data)):
                raise AssertionError(f"tapes: packed entry {w} differs on "
                                     f"{device}")
            nbool += g.data.numel()
            nbits += g.decisions
        elif not (g.dtype == w.dtype and torch.equal(g.cpu(), w)):
            raise AssertionError(f"tapes: {w.dtype} entry differs on {device}")
        elif g.dtype not in (torch.bool, torch.uint8):
            index = (g.dtype, g.element_size())
    with freeze.replaying(tapes[device]):
        replayed = run(device, True)
    for r, p in zip(replayed, preds):
        if not np.array_equal(r.cpu().numpy(), p):
            raise AssertionError(f"tapes: a replayed decision of shape "
                                 f"{p.shape} differs on {device}")
    if index != (torch.uint16, 2):
        raise AssertionError(f"tapes: qsat's table index is stored as "
                             f"{index}, want (torch.uint16, 2)")
    return nbool, nbits, index


def _bump(lm, amp=3.0):
    """The smooth thermal bump of tests/test_nh_e2e.py, (npz, 6, n, n)."""
    n = lm.cfg.dyn.nx
    npz = lm.cfg.dyn.npz
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    faces = np.arange(6)[:, None, None]
    ks = np.arange(npz)[:, None, None, None]
    b = (amp * np.sin(2.0 * np.pi * (jj + 0.5) / n + 0.7 * faces)
         * np.cos(2.0 * np.pi * (ii + 0.5) / n + 0.3 * faces)
         * np.cos(0.5 * np.pi * ks / npz))
    return torch.as_tensor(b, dtype=lm.dtype, device=lm.device)


def _moisten(lm, tr):
    """A smooth positive humidity field, so the tracer transport and remap
    carry a non-zero tracer."""
    tr["qv"] = 5.0e-3 * (1.0 + 0.1 * _bump(lm, amp=1.0))
    return tr


def spun_up(lm, nsteps, moist):
    """The smooth spun-up trajectory of tests/test_lm.py `_spun_up` (moist,
    3 steps) and tests/test_nh_e2e.py `_spun_up` (dry, 2 steps), on the
    port."""
    tr = lm.rest_traj()
    tr["t"] = tr["t"] + _bump(lm)
    if moist:
        n = lm.cfg.dyn.nx
        npz = lm.cfg.dyn.npz
        jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        faces = np.arange(6)[:, None, None]
        qv = 1e-3 * (1.0 + np.sin(2.0 * np.pi * (ii + jj) / n + faces)
                     ) * np.ones((npz, 1, 1, 1))
        tr["qv"] = tr["qv"] + torch.as_tensor(qv, dtype=lm.dtype,
                                              device=lm.device)
    for _ in range(nsteps):
        tr = lm.step_nl(tr)
    return tr


def _draw(lm, rng, shape):
    """rng.standard_normal over the whole cube for a field of `lm` of
    `shape`: on a rank of a decomposition the numbers of the whole cube
    are drawn, as one process draws them, and its own part kept."""
    if lm.faces is None:
        return rng.standard_normal(tuple(shape))
    from fv3jedi_lm_tpu_torch.parallel.faces import NFACES, split_faces

    T = lm.tile
    whole = tuple(shape[:-3]) + (NFACES, T.n + shape[-2] - T.ny,
                                 T.n + shape[-1] - T.nx)
    return split_faces({"x": rng.standard_normal(whole)}, lm.faces,
                       T.n)["x"]


def rand_pert(lm, seed):
    """tests/test_lm.py `_rand_pert` on the port: the same numbers (on a
    rank of a decomposition, its part of them)."""
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(_draw(lm, rng, v.shape) * PERT_SCALE[k],
                               dtype=lm.dtype, device=lm.device)
            for k, v in lm.zero_pert().items()}


def dot(a, b, keys):
    """<a, b> over the fields `keys`, summed in float64 on the host."""
    return sum(float((a[k].double() * b[k].double()).sum()) for k in keys)


def tlad_traj(kw):
    """tlad_devices' trajectory at the configuration `kw`: spun up on the
    CPU (numpy)."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy

    cfg = LMConfig(dyn=DynConfig(**kw), dt=450.0)
    hyd = cfg.dyn.hydrostatic
    cpu = LinearModel.create(cfg, device="cpu")
    return traj_to_numpy(spun_up(cpu, 3 if hyd else 2, moist=hyd))


def tlad_devices(kw, devices=("cuda", "cpu"), traj=None):
    """step_tl(traj, rand_pert(1)) and step_ad(traj, rand_pert(2)) at the
    c12L10 configuration `kw` (float64), from one trajectory spun up on
    the CPU (`traj`, else tlad_traj(kw)), on each device, then
    step_nl(traj).  Returns {device: dict(nl, tl, ad (numpy), dot (the
    identity's relative error), fwd_launches (SIM1 kernel launches of
    `forward`), mixed_launches (of record, TL and AD))}."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                         traj_to_numpy)
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    cfg = LMConfig(dyn=DynConfig(**kw), dt=450.0)
    traj = tlad_traj(kw) if traj is None else traj
    out = {}
    for dev in devices:
        lm = LinearModel.create(cfg, device=dev)
        tr = traj_from_numpy(lm, traj)
        dx, dy = rand_pert(lm, 1), rand_pert(lm, 2)
        stepper = lm._staged()
        record = stepper.record
        fwd = []

        def counted_record(cks, record=record, fwd=fwd):
            # forward has run: its launches, then count the mixed stages'
            fwd.append(sim1_solver_cuda.launches)
            sim1_solver_cuda.launches = 0
            return record(cks)

        stepper.record = counted_record
        sim1_solver_cuda.launches = 0
        mdx = lm.step_tl(tr, dx)
        mtdy = lm.step_ad(tr, dy)
        if dev == "cuda":
            torch.cuda.synchronize()
        mixed = sim1_solver_cuda.launches
        lhs = dot(mdx, dy, lm.prog_3d)
        rhs = dot(dx, mtdy, lm.prog_3d)
        nl = lm.step_nl(tr)
        out[dev] = dict(nl=traj_to_numpy({k: nl[k] for k in lm.prog_3d}),
                        tl=traj_to_numpy(mdx), ad=traj_to_numpy(mtdy),
                        dot=abs(lhs - rhs) / max(abs(lhs), 1e-300),
                        fwd_launches=fwd[0], mixed_launches=mixed)
    return out


def tlad_cpu(kw):
    """tlad_devices' CPU half: (its trajectory, its CPU result)."""
    traj = tlad_traj(kw)
    return traj, tlad_devices(kw, ("cpu",), traj)["cpu"]


def moist_traj(tr, n, npz, rng, asarray):
    """tests/test_moist.py's convective sounding into the trajectory dict
    `tr`, drawing from `rng` in that file's order: a cold top (~225 K) and
    a warm moist surface with noise, ts, a random land mask, the cloud
    base at the lowest level, and condensate and convective cloud fraction
    on a Gaussian profile at 0.7 npz.  `asarray` makes the package's
    arrays."""
    ks = np.arange(npz)[:, None, None, None]
    sh = (npz, 6, n, n)
    tr["t"] = asarray(225.0 + 75.0 * (ks / (npz - 1.0)) ** 1.2
                      + 1.5 * rng.standard_normal(sh))
    qv = 0.018 * np.exp(-3.0 * (1.0 - ks / (npz - 1.0)))
    tr["qv"] = asarray(np.clip(qv * (1.0 + 0.2 * rng.standard_normal(sh)),
                               1e-7, None))
    tr["ts"] = asarray(305.0 + rng.standard_normal((6, n, n)))
    tr["frland"] = asarray((rng.random((6, n, n)) > 0.5) * 1.0)
    tr["kcbl"] = asarray(np.full((6, n, n), float(npz - 1)))
    prof = np.exp(-0.5 * ((ks - 0.7 * npz) / (0.15 * npz)) ** 2)
    tr["qls"] = asarray(4e-5 * prof * (1.0 + 0.3 * rng.random(sh)))
    tr["qcn"] = asarray(3e-5 * prof * (1.0 + 0.3 * rng.random(sh)))
    tr["cfcn"] = asarray(0.1 * prof * np.ones(sh))
    return tr


def turb_sfc(n, rng):
    """tests/test_turbulence.py's surface exchange and stability fields,
    drawn from `rng` in that file's order, as numpy."""
    sfc = dict(ustar=0.2 + 0.1 * rng.random((6, n, n)),
               bstar=0.02 * rng.standard_normal((6, n, n)),
               cm=0.01 * rng.random((6, n, n)),
               ct=0.01 * rng.random((6, n, n)),
               cq=0.01 * rng.random((6, n, n)),
               frocean=(rng.random((6, n, n)) > 0.3) * 1.0)
    sfc["frland"] = 1.0 - sfc["frocean"]
    sfc["varflt"] = 100.0 * rng.random((6, n, n))
    sfc["zpbl"] = 500.0 + 500.0 * rng.random((6, n, n))
    return sfc


def phys_small_traj(lm):
    """tests/test_moist.py's `traj` (seed 7) with tests/test_turbulence.py's
    surface fields (seed 3), on `lm`'s device."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=lm.dtype,
                                     device=lm.device)
    n, npz = lm.cfg.dyn.nx, lm.cfg.dyn.npz
    tr = moist_traj(lm.rest_traj(t0=285.0), n, npz,
                    np.random.default_rng(7), as_t)
    tr.update({k: as_t(v)
               for k, v in turb_sfc(n, np.random.default_rng(3)).items()})
    return tr


def phys_case():
    """phys_devices' inputs, whole cube, numpy: (phys_small_traj,
    rand_pert(1), rand_pert(2)) of a model on the CPU (the same for
    moist modes 1 and 2)."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy

    cfg = LMConfig(dyn=DynConfig(**PHYS_SMALL_KW), dt=450.0, do_phy_trb=True,
                   do_phy_mst=1)
    lm = LinearModel.create(cfg, device="cpu", ak=PHYS_AK, bk=PHYS_BK)
    return tuple(traj_to_numpy(d) for d in (
        phys_small_traj(lm), rand_pert(lm, 1), rand_pert(lm, 2)))


def phys_devices(mode, devices=("cuda", "cpu")):
    """step_nl(traj), step_tl(traj, rand_pert(1)) and step_ad(traj,
    rand_pert(2)) at PHYS_SMALL_KW float64 with the turbulence and moist
    mode `mode`, on each device from the same numbers.  Returns {device:
    dict(nl, tl, ad (numpy), dot (the identity's relative error, counting
    cfcn), doconvec (convecting columns), sim1 (SIM1 kernel launches),
    case (traj, dx, dy as numpy))}."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    cfg = LMConfig(dyn=DynConfig(**PHYS_SMALL_KW), dt=450.0, do_phy_trb=True,
                   do_phy_mst=mode)
    out = {}
    for dev in devices:
        lm = LinearModel.create(cfg, device=dev, ak=PHYS_AK, bk=PHYS_BK)
        tr = phys_small_traj(lm)
        dx, dy = rand_pert(lm, 1), rand_pert(lm, 2)
        sim1_solver_cuda.launches = 0
        nl = lm.step_nl(tr)
        mdx = lm.step_tl(tr, dx)
        mtdy = lm.step_ad(tr, dy)
        if dev == "cuda":
            torch.cuda.synchronize()
        lhs = dot(mdx, dy, lm.prog_3d)
        rhs = dot(dx, mtdy, lm.prog_3d)
        out[dev] = dict(
            nl={k: nl[k].cpu().numpy() for k in lm.prog_3d},
            tl=traj_to_numpy(mdx), ad=traj_to_numpy(mtdy),
            dot=abs(lhs - rhs) / max(abs(lhs), 1e-300),
            doconvec=int(lm._ckpts(tr)[2][0]["doconvec"].sum()),
            sim1=sim1_solver_cuda.launches,
            case=tuple(traj_to_numpy(d) for d in (tr, dx, dy)))
    return out


def phys_cpu(mode):
    """phys_devices' CPU half."""
    return phys_devices(mode, ("cpu",))["cpu"]


def _cpu_worker():
    # the CPU references run at c12 and below, where one thread is about
    # twice as fast as eight (measured on the CPU at c12L10)
    torch.set_num_threads(1)


class CpuReferences:
    """The CPU halves of the small phases' comparisons (small_step_nl,
    tlad_cpu, phys_cpu, options_cpu), computed in spawned worker
    processes, one thread each, while the card runs the GPU halves; the
    same code on the same numbers as in this process.  `get` waits for a
    job's result (raising its error), `wait` for all, `close` stops the
    workers."""

    def __init__(self, workers=3):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self._pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker)
        self._jobs = {}

    def submit(self, key, fn, *args):
        self._jobs[key] = self._pool.submit(fn, *args)

    def get(self, key):
        return self._jobs[key].result(
            timeout=spawn_timeout(3600.0, f"CPU reference {key}"))

    def wait(self):
        from concurrent.futures import wait

        jobs = list(self._jobs.values())
        _, pending = wait(jobs, timeout=spawn_timeout(3600.0,
                                                      "CPU references"))
        if pending:
            raise TimeoutError(f"CPU references: {len(pending)} jobs still "
                               "running at the script's deadline")

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


def submit_cpu_references(refs):
    """Every job of CpuReferences, in the order the phases read them."""
    refs.submit("small", small_step_nl, "cpu")
    for name, kw in TLAD_SMALL.items():
        refs.submit(("tlad", name), tlad_cpu, kw)
    for mode in (1, 2):
        refs.submit(("phys", mode), phys_cpu, mode)
    for name in OPTIONS_SMALL:
        refs.submit(("options", name), options_cpu, name)


def phase_build():
    from fv3jedi_lm_tpu_torch.ops import cuda_sim1

    t0 = time.perf_counter()
    path = cuda_sim1.build()
    cuda_sim1._load()
    print(f"[build] {path.name} built+loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_tapes(card):
    """The packed tape storage on the card (tape_storage)."""
    nbool, nbits, index = tape_storage("cuda")
    print(f"[tapes] on the card: {nbits} decisions in {nbool} packed bytes, "
          f"equal to the CPU's; replayed decisions equal; qsat's table index "
          f"{index[0]}, {index[1]} bytes a value ({card[0]}; {card[1]})",
          flush=True)


def phase_kernel(card):
    """Kernel vs plain on the card at every case of KERNEL_CASES, then the
    timings at the main path's shape; returns the kernel's JSON record."""
    from fv3jedi_lm_tpu_torch.constants import KAPPA
    from fv3jedi_lm_tpu_torch.core.nh_core import sim1_solver
    from fv3jedi_lm_tpu_torch.ops import cuda_sim1
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    dev = torch.device("cuda")
    dt = 150.0  # the acoustic step of c96L72: 900 s / n_split 6
    max_abs_main = None
    for i, (dtype, km, ncol) in enumerate(KERNEL_CASES):
        args = _sim1_inputs(km, ncol, i, getattr(torch, dtype), dev)
        ref = sim1_solver(dt, *args, KAPPA, 0.05)
        got = sim1_solver_cuda(dt, *args, KAPPA, 0.05)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("pe", "w", "dz"), ref, got):
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"kernel {dtype} ({km}, {ncol}) {name}: "
                                     "non-finite values")
            errs.append(float((a - b).abs().max()))
            if dtype == "float32":
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"kernel {dtype} ({km}, {ncol}) {name}: max|d| "
                        f"{errs[-1]} != 0 (float32 must be bitwise)")
            else:
                torch.testing.assert_close(
                    b, a, rtol=1e-12, atol=1e-12,
                    msg=f"kernel {dtype} ({km}, {ncol}) {name}")
        tile, threads, smem = cuda_sim1.plan(km, args[0].element_size())
        print(f"[kernel] {dtype} ({km}, {ncol}) tile {tile} x {threads} "
              f"threads, {smem} B shared: max|d| pe/w/dz = "
              + " ".join(f"{e:.3e}" for e in errs)
              + (" (bitwise)" if dtype == "float32"
                 else " (rtol=atol=1e-12)"), flush=True)
        if (dtype, km, ncol) == ("float32", KM, B_FULL):
            max_abs_main = max(errs)

    # timings at the main path's shape, float32
    args = _sim1_inputs(KM, B_FULL, 0, torch.float32, dev)
    ms = _time_ms(lambda: sim1_solver_cuda(dt, *args, KAPPA, 0.05))
    ms_single = _time_single_ms(lambda: sim1_solver_cuda(dt, *args, KAPPA,
                                                         0.05))
    copy_ms = _time_ms(lambda: cuda_sim1._launch(dt, args, KAPPA, 0.05,
                                                 mode=1))
    solve_ms = _time_ms(lambda: cuda_sim1._launch(dt, args, KAPPA, 0.05,
                                                  mode=2))
    plain_ms = _time_ms(lambda: sim1_solver(dt, *args, KAPPA, 0.05),
                        batches=5, batch=1)
    bound_ms, bound_by = sim1_bound_ms(KM, B_FULL, 4)
    tile, threads, _ = cuda_sim1.plan(KM, 4)
    print(f"[kernel] time ({KM}, {B_FULL}) float32, tile {tile} x "
          f"{threads}: kernel {ms:.4f} ms (batched; {ms_single:.4f} ms "
          f"timed one call at a time), copy only {copy_ms:.4f} ms, solve "
          f"only {solve_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it "
          f"({card[1]})", flush=True)
    for t, th in ((32, 256), (32, 128), (16, 256), (16, 128), (8, 256)):
        sweep = _time_ms(lambda: cuda_sim1._launch(dt, args, KAPPA, 0.05,
                                                   tile=t, threads=th))
        print(f"[kernel] tile {t} x {th} threads: {sweep:.4f} ms",
              flush=True)
    return dict(name="sim1_solver", route="cuda",
                source="fv3jedi_lm_tpu_torch/csrc/sim1.cu",
                replaces="fv3jedi_lm_tpu/ops/pallas_sim1.py:109",
                launches=None, max_abs_err=max_abs_main, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, ms_one_call=ms_single, copy_only_ms=copy_ms,
                solve_only_ms=solve_ms)


def small_step_nl(dev):
    """phase_small's step_nl on `dev`: c12L10 float64, one step from the
    bump state (with humidity), checking its SIM1 launches (2 per
    acoustic substep on the card, none on the CPU).  Returns the
    prognostic fields (numpy)."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    cfg = LMConfig(dyn=DynConfig(**SMALL_KW), dt=450.0)
    lm = LinearModel.create(cfg, device=dev)
    tr = lm.rest_traj()
    tr["t"] = tr["t"] + _bump(lm)
    tr = _moisten(lm, tr)
    sim1_solver_cuda.launches = 0
    out = traj_to_numpy(lm.step_nl(tr))
    launches = sim1_solver_cuda.launches
    want = 2 * cfg.dyn.n_split if dev == "cuda" else 0
    if launches != want:
        raise AssertionError(f"{dev}: {launches} SIM1 launches, "
                             f"expected {want}")
    return {k: out[k] for k in lm.prog_3d}


def phase_small(refs):
    """The port on the GPU (kernel) vs the port on the CPU (plain, from
    the worker `refs`), small_step_nl; then rest stays at rest."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel

    cfg = LMConfig(dyn=DynConfig(**SMALL_KW), dt=450.0)
    outs = {"cuda": small_step_nl("cuda"), "cpu": refs.get("small")}
    for k, a in outs["cpu"].items():
        b = outs["cuda"][k]
        d = float(np.abs(a - b).max())
        scale = float(np.abs(a).max())
        print(f"[small] {k}: max|cuda-cpu|={d:.3e} max|cpu|={scale:.3e}",
              flush=True)
        if not d <= 1e-10 * scale:
            raise AssertionError(f"small {k}: {d} > 1e-10*{scale}")
    print(f"[small] SIM1 launches in one cuda step_nl: "
          f"{2 * cfg.dyn.n_split} (2 per acoustic substep)", flush=True)

    lm = LinearModel.create(cfg)  # the card, by default
    if lm.device.type != "cuda":
        raise AssertionError(f"LinearModel.create defaulted to {lm.device}")
    out = lm.step_nl(lm.rest_traj())
    u = float(out["u"].abs().max())
    w = float(out["w"].abs().max())
    t = float((out["t"] - 280.0).abs().max())
    print(f"[small] rest (device {lm.device}): max|u|={u:.3e} "
          f"max|w|={w:.3e} max|t-280|={t:.3e}", flush=True)
    if not (u < 1e-8 and w < 1e-8 and t < 1e-7):
        raise AssertionError("rest state did not stay at rest")


def phase_full(card, nt=3):
    """c96L72 NH float32 (the bench.py NH configuration): run_nl over nt
    steps from rest plus the thermal bump and humidity.  Returns the model,
    the last state and the SIM1 launches of the run."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    cfg = LMConfig(dyn=DynConfig(**FULL_KW), dt=FULL_DT, nt=nt)
    lm = LinearModel.create(cfg)
    tr0 = lm.rest_traj()
    tr0["t"] = tr0["t"] + _bump(lm)
    tr0 = _moisten(lm, tr0)
    torch.cuda.synchronize()

    times = []
    step = lm.step_nl

    def timed_step(tr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(tr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    lm.step_nl = timed_step
    torch.cuda.reset_peak_memory_stats()
    sim1_solver_cuda.launches = 0
    trajs = lm.run_nl(tr0)
    launches = sim1_solver_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    del lm.step_nl           # the class's method again, no cycle left

    for i, tr in enumerate(trajs[1:], 1):
        for k in lm.prog_3d:
            if not bool(torch.isfinite(tr[k]).all()):
                raise AssertionError(f"full: step {i} {k} not finite")
    last = trajs[-1]
    print(f"[full] c96L72 NH f32 dt=900 n_split=6: {nt} steps finite; "
          f"max|w|={float(last['w'].abs().max()):.4e} "
          f"max|u|={float(last['u'].abs().max()):.4e} "
          f"t in [{float(last['t'].min()):.3f}, "
          f"{float(last['t'].max()):.3f}]", flush=True)
    want = 2 * cfg.dyn.n_split * nt
    if launches != want:
        raise AssertionError(f"full: {launches} SIM1 launches, expected "
                             f"{want}")
    print(f"[full] SIM1 kernel launches in run_nl: {launches} "
          f"(= 2 x {cfg.dyn.n_split} x {nt})", flush=True)
    print(f"[full] step_nl seconds: first (warm-up) {times[0]:.4f}, then "
          + ", ".join(f"{t:.4f}" for t in times[1:])
          + f"; peak device memory {peak / 2**30:.3f} GiB "
          f"({card[0]}; {card[1]})", flush=True)
    return lm, last, launches


def phase_profile(lm, tr):
    """One more warm c96L72 step under torch.profiler: the SIM1 kernel's
    events, found by kernel name, must number 2 per acoustic substep;
    prints their summed device time and the step's kernel time."""
    from torch.profiler import ProfilerActivity, profile

    want = 2 * lm.cfg.dyn.n_split
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm.step_nl(tr)
        torch.cuda.synchronize()
    sim1_n, sim1_us, kernel_us = 0, 0.0, 0.0
    for evt in prof.events():
        # device events only, without the scopes' ranges mirrored onto the
        # device timeline (they nest and would count kernels again)
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        kernel_us += evt.device_time_total
        if "sim1_kernel" in evt.name:
            sim1_n += 1
            sim1_us += evt.device_time_total
    print(f"[profile] c96L72 step: {sim1_n} SIM1 kernel events, "
          f"{sim1_us / 1e3:.4f} ms of device time in all "
          f"({sim1_us / max(sim1_n, 1) / 1e3:.4f} ms each); all kernels "
          f"{kernel_us / 1e3:.3f} ms", flush=True)
    if sim1_n != want:
        raise AssertionError(f"profile: {sim1_n} SIM1 kernel events, "
                             f"expected {want}")


def phase_tlad_small(refs):
    """The TL/AD pair on the GPU against the CPU (from the worker `refs`)
    at c12L10 float64, hydrostatic and nonhydrostatic: every field to
    1e-10 relative norm, the dot-product identity below 1e-12 on the card,
    and SIM1 by mode: the trajectory substeps of `forward` launch the
    kernel (2 per substep, nonhydrostatic), the differentiated stages
    never do.  Returns {mode: (trajectory, tlad_devices' results on the
    card and the CPU)}."""
    out = {}
    for name, kw in TLAD_SMALL.items():
        traj, cpu = refs.get(("tlad", name))
        res = tlad_devices(kw, ("cuda",), traj)
        res["cpu"] = cpu
        out[name] = (traj, res)
        n_split = kw["n_split"]
        for sweep in ("tl", "ad"):
            worst = 0.0
            for k, want in res["cpu"][sweep].items():
                got = res["cuda"][sweep][k]
                if not np.isfinite(got).all():
                    raise AssertionError(f"tlad small {name} {sweep} {k}: "
                                         "non-finite values")
                rel = float(np.linalg.norm(got - want)
                            / max(np.linalg.norm(want), 1e-300))
                worst = max(worst, rel)
                if not rel <= 1e-10:
                    raise AssertionError(f"tlad small {name} {sweep} {k}: "
                                         f"|cuda-cpu|/|cpu| = {rel} > 1e-10")
            print(f"[tlad_small] {name} {sweep}: max over fields of "
                  f"|cuda-cpu|/|cpu| = {worst:.3e}", flush=True)
        for dev, r in res.items():
            print(f"[tlad_small] {name} {dev}: dot-product identity "
                  f"{r['dot']:.3e}; SIM1 kernel launches: forward "
                  f"{r['fwd_launches']}, record+TL+AD {r['mixed_launches']}",
                  flush=True)
        want_fwd = 0 if kw.get("hydrostatic", True) else 2 * n_split
        if not res["cuda"]["dot"] < 1e-12:
            raise AssertionError(f"tlad small {name}: dot-product identity "
                                 f"{res['cuda']['dot']} >= 1e-12 on the card")
        if (res["cuda"]["fwd_launches"], res["cuda"]["mixed_launches"]) != (
                want_fwd, 0):
            raise AssertionError(
                f"tlad small {name}: SIM1 launches forward "
                f"{res['cuda']['fwd_launches']} (want {want_fwd}), mixed "
                f"{res['cuda']['mixed_launches']} (want 0)")
    return out


def _bench_case(lm):
    """bench.py's trajectory and perturbation (bench.py:182-188, seed 0):
    rest plus 2 K of white noise on t, and a 1e-3 white-noise pert (on a
    rank of a decomposition, its part of them)."""
    traj = lm.rest_traj()
    rng = np.random.default_rng(0)
    noise = 2.0 * _draw(lm, rng, traj["t"].shape).astype(np.float32)
    traj["t"] = traj["t"] + torch.as_tensor(noise, device=lm.device)
    pert = {k: torch.as_tensor(
        (1e-3 * _draw(lm, rng, v.shape)).astype(np.float32),
        device=lm.device) for k, v in lm.zero_pert().items()}
    return traj, pert


def phase_tlad_full(card, pairs=3):
    """c96L72 hydrostatic float32 (bench.py's configuration and inputs):
    one first pair of step_tl + step_ad(traj, tl) (with the trajectory's
    forward and record, timed on their own), then `pairs` timed pairs,
    each ending in torch.cuda.synchronize() (bench.py:199-209).  Returns
    (lm, traj, pert, best pair seconds, SIM1 launches of the run)."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    cfg = LMConfig(dyn=DynConfig(**TLAD_FULL_KW), dt=FULL_DT)
    lm = LinearModel.create(cfg)
    traj, pert = _bench_case(lm)
    stepper = lm._staged()
    parts = {}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            return out
        return run

    stepper.forward = timed("forward", stepper.forward)
    stepper.record = timed("record", stepper.record)

    def pair():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tl = lm.step_tl(traj, pert)
        ad = lm.step_ad(traj, tl)
        torch.cuda.synchronize()
        return tl, ad, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    sim1_solver_cuda.launches = 0
    tl, ad, first = pair()
    times = []
    for _ in range(pairs):
        tl, ad, t = pair()
        times.append(t)
    launches = sim1_solver_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    del stepper.forward, stepper.record

    for what, d in (("tl", tl), ("ad", ad)):
        for k in lm.prog_3d:
            if not bool(torch.isfinite(d[k]).all()):
                raise AssertionError(f"tlad full {what} {k}: not finite")
            if not bool((d[k] != 0).any()):
                raise AssertionError(f"tlad full {what} {k}: all zero")
    lhs = dot(tl, tl, lm.prog_3d)
    rhs = dot(pert, ad, lm.prog_3d)
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-300)
    if not np.isfinite(rel):
        raise AssertionError(f"tlad full: dot-product error {rel}")
    best = min(times)
    n = cfg.dyn.nx
    print(f"[tlad_full] c96L72 hydrostatic f32 dt=900 n_split=6: first pair "
          f"{first:.4f} s (forward {parts['forward']:.4f} s, record "
          f"{parts['record']:.4f} s), then pairs "
          + ", ".join(f"{t:.4f}" for t in times) + " s", flush=True)
    print_cached("tlad_full", lm, card)
    print(f"[tlad_full] best pair {best:.4f} s: "
          f"{n * n * 6 * cfg.dyn.npz / best:.1f} grid-points/s; peak device "
          f"memory {peak / 2**30:.3f} GiB; SIM1 launches {launches}; "
          f"dot-product <M p, M p> vs <p, M^T M p> relative error {rel:.3e} "
          f"(float32) ({card[0]}; {card[1]})", flush=True)
    if launches != 0:
        raise AssertionError(f"tlad full: {launches} SIM1 launches on the "
                             "hydrostatic path")
    return lm, traj, pert, best, launches


#: the profile scopes of the TL/AD sweeps (core/staged.py) and of the
#: stages they run
TLAD_SCOPES = ("tl.prep", "tl.pre", "tl.substep", "tl.post", "ad.post",
               "ad.stage_c", "ad.stage_b", "ad.stage_a", "ad.pre", "ad.prep",
               "halo_uv", "c_sw", "geopk_c", "p_grad_c", "d_sw", "d_sw_pert",
               "geopk_d", "one_grad_p", "acoustic_finish", "tracer_2d",
               "remap")


class _RawProfile(torch.autograd.profiler.profile):
    """torch.autograd.profiler.profile that keeps the raw Kineto events
    and does not build the FunctionEvent tree from them, which takes
    minutes for the million events of a pair."""

    def _parse_kineto_results(self, result):
        return []


def profile_pair(lm, traj, pert, scopes):
    """One step_tl + step_ad(traj, tl) under the profiler: (profiled wall
    s, device events, device us, {scope: dict(calls, launches, dev_us,
    host_us)}).  A scope's device events are those of the operators that
    start inside it, matched by the Kineto correlation id; its host time
    is the scope's own duration.  Prints the seconds the trace took to
    collect and read."""
    import bisect

    with _RawProfile(use_device="cuda", use_kineto=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tl = lm.step_tl(traj, pert)
        lm.step_ad(traj, tl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_read = time.perf_counter()
    ops, ranges, per_op = [], [], {}
    n_dev, dev_us = 0, 0.0
    for e in prof.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            us = e.duration_ns() / 1e3
            n_dev += 1
            dev_us += us
            c = e.linked_correlation_id()
            k, t = per_op.get(c, (0, 0.0))
            per_op[c] = (k + 1, t + us)
        elif e.is_user_annotation():
            if e.name() in scopes:
                ranges.append((e.name(), e.start_ns(), e.end_ns()))
        else:
            ops.append((e.start_ns(), e.correlation_id()))
    ops.sort()
    starts = [t for t, _ in ops]
    out = {name: dict(calls=0, launches=0, dev_us=0.0, host_us=0.0)
           for name in scopes}
    for name, t0, t1 in ranges:
        r = out[name]
        r["calls"] += 1
        r["host_us"] += (t1 - t0) / 1e3
        for _, c in ops[bisect.bisect_left(starts, t0):
                        bisect.bisect_right(starts, t1)]:
            k, t = per_op.get(c, (0, 0.0))
            r["launches"] += k
            r["dev_us"] += t
    print(f"[profile_pair] the trace of {n_dev} device events collected "
          f"and read in {time.perf_counter() - t_read:.1f} s", flush=True)
    return wall, n_dev, dev_us, out


def phase_tlad_profile(lm, traj, pert, best):
    """One warm c96L72 pair under torch.profiler: its kernel launches,
    kernel time and busy share, and the kernel and host time by scope."""
    wall, n_kernels, kernel_us, by = profile_pair(lm, traj, pert,
                                                  TLAD_SCOPES)
    print(f"[tlad_profile] c96L72 pair: {n_kernels} kernel launches, "
          f"{kernel_us / 1e3:.3f} ms of kernel time; profiled wall "
          f"{wall:.4f} s (busy {100 * kernel_us / 1e6 / wall:.1f} %), "
          f"unprofiled best pair {best:.4f} s (busy "
          f"{100 * kernel_us / 1e6 / best:.1f} %)", flush=True)
    for name, r in by.items():
        if r["calls"]:
            print(f"[tlad_profile] scope {name}: {r['calls']} calls, kernels "
                  f"{r['dev_us'] / 1e3:.3f} ms, host "
                  f"{r['host_us'] / 1e3:.3f} ms", flush=True)
    if n_kernels == 0:
        raise AssertionError("tlad profile: no kernel events in the trace")


def phase_phys_small(refs):
    """The TL/AD pair and step_nl with the physics on the GPU against the
    CPU (from the worker `refs`) at c8L12 float64 (tests/test_moist.py's
    configuration and trajectory, the turbulence on), moist modes 1 and 2:
    every field to 1e-10 of its largest value, the dot-product identity
    below 1e-12 on the card counting cfcn, some column convecting in mode
    1, and no SIM1 launch on the hydrostatic path.  Returns the card's
    results {mode: phys_devices' dict} (with their inputs, numpy)."""
    card_res = {}
    for mode in (1, 2):
        res = phys_devices(mode, ("cuda",))
        res["cpu"] = refs.get(("phys", mode))
        for sweep in ("nl", "tl", "ad"):
            worst = 0.0
            for k, want in res["cpu"][sweep].items():
                got = res["cuda"][sweep][k]
                if not np.isfinite(got).all():
                    raise AssertionError(f"phys small mode {mode} {sweep} "
                                         f"{k}: non-finite values")
                rel = float(np.abs(got - want).max()
                            / max(np.abs(want).max(), 1e-300))
                worst = max(worst, rel)
                if not rel <= 1e-10:
                    raise AssertionError(
                        f"phys small mode {mode} {sweep} {k}: max|cuda-cpu|"
                        f"/max|cpu| = {rel} > 1e-10")
            print(f"[phys_small] mode {mode} {sweep}: max over fields of "
                  f"max|cuda-cpu|/max|cpu| = {worst:.3e}", flush=True)
        for dev, r in res.items():
            print(f"[phys_small] mode {mode} {dev}: dot-product identity "
                  f"{r['dot']:.3e}; convecting columns {r['doconvec']} of "
                  f"384; SIM1 launches {r['sim1']}", flush=True)
        cu = res["cuda"]
        if not cu["dot"] < 1e-12:
            raise AssertionError(f"phys small mode {mode}: dot-product "
                                 f"identity {cu['dot']} >= 1e-12 on the card")
        if mode == 1 and cu["doconvec"] == 0:
            raise AssertionError("phys small mode 1: no column convects")
        if cu["sim1"] != 0:
            raise AssertionError(f"phys small mode {mode}: {cu['sim1']} SIM1 "
                                 "launches on the hydrostatic path")
        card_res[mode] = cu
    return card_res


def _phys_full_case(lm):
    """The c96L72 physics trajectory and perturbation, from seed 0 with
    numpy: the bench state (rest) with tests/test_moist.py's convective
    sounding at npz 72, frocean = 1 - frland, tests/test_turbulence.py's
    exchange fields; the perturbation rand_pert(lm, 1)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=lm.dtype,
                                     device=lm.device)
    n, npz = lm.cfg.dyn.nx, lm.cfg.dyn.npz
    rng = np.random.default_rng(0)
    tr = moist_traj(lm.rest_traj(), n, npz, rng, as_t)
    sfc = turb_sfc(n, rng)
    sfc["frocean"] = 1.0 - tr["frland"].cpu().numpy()
    del sfc["frland"]
    tr.update({k: as_t(v) for k, v in sfc.items()})
    return tr, rand_pert(lm, 1)


def phase_phys_full(card, pairs=2):
    """c96L72 hydrostatic float32 with the turbulence and moist mode 1 on
    the convective sounding: one first pair of step_tl + step_ad(traj, tl)
    (with the trajectory's forward, record and the two physics
    linearizations timed on their own), then `pairs` timed pairs.  Checks
    that every output is finite and that the physics acts (some column
    convects, the turbulence mixes, the TL differs from the dynamics-only
    TL).  Returns (lm, traj, pert, best pair seconds, SIM1 launches, the
    inputs and the last pair as numpy: dict(traj, pert, tl, ad))."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.core import freeze
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    cfg = LMConfig(dyn=DynConfig(**TLAD_FULL_KW), dt=FULL_DT,
                   do_phy_trb=True, do_phy_mst=1)
    lm = LinearModel.create(cfg)
    traj, pert = _phys_full_case(lm)
    stepper = lm._staged()
    parts = {}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            return out
        return run

    stepper.forward = timed("forward", stepper.forward)
    stepper.record = timed("record", stepper.record)
    lm._moist.linearize = timed("moist", lm._moist.linearize)
    lm._turb_ltraj = timed("turb", lm._turb_ltraj)

    def pair():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tl = lm.step_tl(traj, pert)
        ad = lm.step_ad(traj, tl)
        torch.cuda.synchronize()
        return tl, ad, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    sim1_solver_cuda.launches = 0
    tl, ad, first = pair()
    times = []
    for _ in range(pairs):
        tl, ad, t = pair()
        times.append(t)
    launches = sim1_solver_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    del stepper.forward, stepper.record, lm._moist.linearize, lm._turb_ltraj

    for what, d in (("tl", tl), ("ad", ad)):
        for k in lm.prog_3d:
            if not bool(torch.isfinite(d[k]).all()):
                raise AssertionError(f"phys full {what} {k}: not finite")
    cks, tapes, mpack, ltraj = lm._ckpts(traj)
    print_cached("phys_full", lm, card)
    index = [e for e, _ in freeze.leaves(mpack[1])
             if isinstance(e, torch.Tensor) and e.dtype == torch.uint16]
    n_idx = sum(e.numel() for e in index)
    b_idx = sum(e.numel() * e.element_size() for e in index)
    print(f"[phys_full] qsat's table index on the moist tape: "
          f"{len(index)} uint16 entries, {n_idx} values in {b_idx} B "
          f"({card[0]}; {card[1]})", flush=True)
    if not index or b_idx != 2 * n_idx:
        raise AssertionError(f"phys full: qsat's table index takes {b_idx} "
                             f"B for {n_idx} values, want 2 a value")
    share = float(mpack[0]["doconvec"].float().mean())
    aks = float(ltraj["aks"].abs().max())
    dyn = lm._staged().tl({k: traj[k] for k in lm.prog_3d}, traj["phis"],
                          {k: pert[k] for k in lm.prog_3d}, cks, tapes)
    tl_diff = max(float((tl[k] - dyn[k]).abs().max()) for k in lm.prog_3d)
    del dyn
    lhs = dot(tl, tl, lm.prog_3d)
    rhs = dot(pert, ad, lm.prog_3d)
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-300)
    if not np.isfinite(rel):
        raise AssertionError(f"phys full: dot-product error {rel}")
    best = min(times)
    n = cfg.dyn.nx
    print(f"[phys_full] c96L72 hydrostatic f32 dt=900 n_split=6, turbulence "
          f"+ moist mode 1: first pair {first:.4f} s (forward "
          f"{parts['forward']:.4f} s, record {parts['record']:.4f} s, moist "
          f"set_ltraj {parts['moist']:.4f} s, turbulence set_ltraj "
          f"{parts['turb']:.4f} s), then pairs "
          + ", ".join(f"{t:.4f}" for t in times) + " s", flush=True)
    print(f"[phys_full] best pair {best:.4f} s: "
          f"{n * n * 6 * cfg.dyn.npz / best:.1f} grid-points/s; peak device "
          f"memory {peak / 2**30:.3f} GiB; convecting columns "
          f"{100 * share:.2f} %; max|aks| {aks:.4e}; max|TL - dynamics-only "
          f"TL| {tl_diff:.4e}; SIM1 launches {launches}; dot-product <M p, "
          f"M p> vs <p, M^T M p> relative error {rel:.3e} (float32) "
          f"({card[0]}; {card[1]})", flush=True)
    if not (share > 0.0 and aks > 0.0 and tl_diff > 0.0):
        raise AssertionError(
            f"phys full: the physics does not act (convecting share {share}, "
            f"max|aks| {aks}, TL difference {tl_diff})")
    if launches != 0:
        raise AssertionError(f"phys full: {launches} SIM1 launches on the "
                             "hydrostatic path")
    ref = dict(traj=traj_to_numpy(traj), pert=traj_to_numpy(pert),
               tl=traj_to_numpy(tl), ad=traj_to_numpy(ad))
    return lm, traj, pert, best, launches, ref


#: the scopes of the pair with physics: the dynamics sweeps and the
#: physics' own
PHYS_SCOPES = ("step_tl", "step_tl.moist", "step_tl.turb", "step_ad.turb",
               "step_ad.moist", "step_ad")
def phase_phys_profile(lm, traj, pert, best):
    """One warm c96L72 pair with the physics under torch.profiler: its
    kernel launches, kernel time and busy share, and per scope the
    launches, kernel time, host time and busy share."""
    wall, n_kernels, kernel_us, by = profile_pair(lm, traj, pert,
                                                  PHYS_SCOPES)
    print(f"[phys_profile] c96L72 pair with physics: {n_kernels} kernel "
          f"launches, {kernel_us / 1e3:.3f} ms of kernel time; profiled wall "
          f"{wall:.4f} s (busy {100 * kernel_us / 1e6 / wall:.1f} %), "
          f"unprofiled best pair {best:.4f} s (busy "
          f"{100 * kernel_us / 1e6 / best:.1f} %)", flush=True)
    for name, r in by.items():
        if not (r["calls"] and r["launches"]):
            raise AssertionError(f"phys profile: scope {name} has no "
                                 "kernel launches in the trace")
        print(f"[phys_profile] scope {name}: {r['launches']} launches, "
              f"kernels {r['dev_us'] / 1e3:.3f} ms, host "
              f"{r['host_us'] / 1e3:.3f} ms, busy "
              f"{100 * r['dev_us'] / max(r['host_us'], 1e-9):.1f} %",
              flush=True)
    if n_kernels == 0:
        raise AssertionError("phys profile: no kernel events in the trace")


def _rel_max(got, want):
    """max|got - want| / max|want|, and whether got is finite."""
    return (float(np.abs(got - want).max())
            / max(float(np.abs(want).max()), 1e-300),
            bool(np.isfinite(got).all()))


def options_traj(name):
    """The trajectory of option `name` of OPTIONS_SMALL (c12L10 float64):
    spun up on the CPU (numpy), with fill_dp's thinned layer."""
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy

    cfg = _options_cfg(name)
    cpu = LinearModel.create(cfg, device="cpu")
    tr = spun_up(cpu, 2, moist=cfg.dyn.hydrostatic)
    if name == "fill_dp":
        # tests/test_mix_dp.py: a thinned layer, so that mix_dp mixes
        delp = tr["delp"].clone()
        delp[4, :, 3:6, 3:6] *= 0.002
        tr = cpu.step_nl(dict(tr, delp=delp))
    return traj_to_numpy(tr)


def _options_cfg(name):
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig

    return LMConfig(dyn=DynConfig(**TLAD_SMALL["hydrostatic"],
                                  **OPTIONS_SMALL[name]), dt=450.0)


def options_run(name, dev, traj):
    """Option `name` on `dev` from the trajectory `traj`: step_nl (numpy,
    with omga for omega), its SIM1 launches, and but for omega step_tl,
    step_ad, their SIM1 launches and the dot-product identity's relative
    error; `keys` the fields to compare."""
    from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                         traj_to_numpy)
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    lm = LinearModel.create(_options_cfg(name), device=dev)
    tr = traj_from_numpy(lm, traj)
    sim1_solver_cuda.launches = 0
    nl = traj_to_numpy(lm.step_nl(tr))
    r = dict(nl=nl, nl_launches=sim1_solver_cuda.launches,
             keys=lm.prog_3d + (("omga",) if name == "omega" else ()))
    if name != "omega":
        dx, dy = rand_pert(lm, 1), rand_pert(lm, 2)
        sim1_solver_cuda.launches = 0
        mdx = lm.step_tl(tr, dx)
        mtdy = lm.step_ad(tr, dy)
        r.update(tl=traj_to_numpy(mdx), ad=traj_to_numpy(mtdy),
                 launches=sim1_solver_cuda.launches)
        lhs = dot(mdx, dy, lm.prog_3d)
        rhs = dot(dx, mtdy, lm.prog_3d)
        r["dot"] = abs(lhs - rhs) / max(abs(lhs), 1e-300)
    return r


def options_cpu(name):
    """phase_options_small's CPU half of option `name`: (its trajectory,
    options_run on the CPU)."""
    traj = options_traj(name)
    return traj, options_run(name, "cpu", traj)


def phase_options_small(refs):
    """Each dynamics option of OPTIONS_SMALL on its own, at c12L10 float64,
    on the GPU against the CPU (from the worker `refs`) from one
    trajectory spun up on the CPU: step_nl (with omega, the omga
    diagnostic), step_tl and step_ad each to 1e-10 of every field's
    largest value, the dot-product identity below 1e-12 on the card, and
    SIM1 by mode (the nonhydrostatic beta case launches it 2 times per
    substep in the trajectory forward, never in the differentiated stages;
    the hydrostatic cases never).  Each line's seconds are the card's run
    and the wait for its CPU half."""
    for name in OPTIONS_SMALL:
        t0 = time.perf_counter()
        cfg = _options_cfg(name)
        hyd = cfg.dyn.hydrostatic
        tlad = name != "omega"
        traj, cpu = refs.get(("options", name))
        res = {"cuda": options_run(name, "cuda", traj), "cpu": cpu}
        keys = cpu["keys"]
        worst = {}
        for what in ("nl", "tl", "ad") if tlad else ("nl",):
            for k in keys:
                rel, fin = _rel_max(res["cuda"][what][k],
                                    res["cpu"][what][k])
                if not (fin and rel <= 1e-10):
                    raise AssertionError(
                        f"options small {name} {what} {k}: finite {fin}, "
                        f"max|cuda-cpu|/max|cpu| = {rel}")
                worst[what] = max(worst.get(what, 0.0), rel)
        if name == "omega" and not np.abs(res["cuda"]["nl"]["omga"]).max(
                ) > 0.0:
            raise AssertionError("options small omega: omga is zero")
        want_nl = 0 if hyd else 2 * cfg.dyn.n_split
        if res["cuda"]["nl_launches"] != want_nl:
            raise AssertionError(
                f"options small {name}: {res['cuda']['nl_launches']} SIM1 "
                f"launches in step_nl, want {want_nl}")
        msg = (f"[options_small] {name}: max over fields of "
               f"max|cuda-cpu|/max|cpu| "
               + ", ".join(f"{w} {v:.3e}" for w, v in worst.items())
               + f"; SIM1 launches step_nl {res['cuda']['nl_launches']}")
        if tlad:
            if not res["cuda"]["dot"] < 1e-12:
                raise AssertionError(f"options small {name}: dot-product "
                                     f"identity {res['cuda']['dot']} on the "
                                     "card")
            # the TL's trajectory forward launches SIM1 (NH), the
            # differentiated stages never
            if res["cuda"]["launches"] != want_nl:
                raise AssertionError(
                    f"options small {name}: {res['cuda']['launches']} SIM1 "
                    f"launches in step_tl + step_ad, want {want_nl} (the "
                    "trajectory forward only)")
            msg += (f", step_tl + step_ad {res['cuda']['launches']}; "
                    f"identity on the card {res['cuda']['dot']:.3e}, on "
                    f"the CPU {res['cpu']['dot']:.3e}")
        print(msg + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_window_full(card, nt=WINDOW_NT):
    """The 4D-Var window at c96L72 hydrostatic float32 (WINDOW_KW, dt 900)
    with the production options, LMConfig(nt, saveltraj=True), on
    _bench_case's trajectory and perturbation: run_nl (with omega), then
    run_tl(p) and run_ad(run_tl(p)) twice, each window timed to a
    synchronize, the first apart (it makes the linearizations); the bytes
    of each cached step's checkpoints, bool tapes and integer tapes
    (print_cached); the float32 window dot-product error; the host
    timers' table; then the window once with saveltraj=False at nt=1 (the
    step linearized again).  After each window the dropped model
    must have returned its device memory (memory_returned).  SIM1's
    launches counted over the window (0: hydrostatic).  Returns the SIM1
    launches."""
    from fv3jedi_lm_tpu_torch import timing
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

    def sync_time(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check(d, what, keys, nonzero=True):
        for k in keys:
            if not bool(torch.isfinite(d[k]).all()):
                raise AssertionError(f"window {what} {k}: not finite")
            if nonzero and not bool((d[k] != 0).any()):
                raise AssertionError(f"window {what} {k}: all zero")

    def window(saveltraj, steps):
        cfg = LMConfig(dyn=DynConfig(**WINDOW_KW, **PRODUCTION_OPTIONS,
                                     compute_omega=True),
                       dt=FULL_DT, nt=steps, saveltraj=saveltraj)
        lm = LinearModel.create(cfg)
        traj0, pert = _bench_case(lm)
        trajs, t_nl = sync_time(lm.run_nl, traj0)
        for tr in trajs[1:]:
            check(tr, "run_nl", lm.prog_3d + ("omga",), nonzero=False)
        return lm, trajs, pert, t_nl

    sim1_solver_cuda.launches = 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timing.timing_reset()
    timing.enable(True)
    lm, trajs, pert, t_nl = window(True, nt)
    omga = max(float(tr["omga"].abs().max()) for tr in trajs[1:])
    runs = []
    for _ in range(2):
        tl, t_tl = sync_time(lm.run_tl, trajs, pert)
        ad, t_ad = sync_time(lm.run_ad, trajs, tl)
        runs.append((t_tl, t_ad))
    timing.enable(False)
    peak = torch.cuda.max_memory_allocated()
    check(tl, "run_tl", lm.prog_3d)
    check(ad, "run_ad", lm.prog_3d)
    lhs = dot(tl, tl, lm.prog_3d)
    rhs = dot(pert, ad, lm.prog_3d)
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-300)
    if not rel < 1e-3:
        raise AssertionError(f"window: dot-product error {rel}")
    if not float(tl["u"].abs().max()) < 1e3:
        raise AssertionError("window: the TL grew from a 1e-3 perturbation "
                             f"to {float(tl['u'].abs().max())} m/s")
    cached = print_cached("window_full", lm, card)
    if len(cached) != nt:
        raise AssertionError(f"window: {len(cached)} cached steps, want {nt}")
    tag = f"({card[0]}; {card[1]})"
    print(f"[window_full] c96L72 hydrostatic f32 dt=900 nt={nt}, pert "
          f"sponge d2_bg_k1/k2/ks_pert 0.2/0.12/0.06, with "
          f"{PRODUCTION_OPTIONS} and compute_omega: run_nl {t_nl:.4f} s "
          f"({t_nl / nt:.4f} s a step); max|omga| {omga:.4e} Pa/s "
          f"{tag}", flush=True)
    for i, (t_tl, t_ad) in enumerate(runs):
        print(f"[window_full] {'first' if i == 0 else 'warm'} window: "
              f"run_tl {t_tl:.4f} s ({t_tl / nt:.4f} s a step), run_ad "
              f"{t_ad:.4f} s ({t_ad / nt:.4f} s a step), TL+AD "
              f"{t_tl + t_ad:.4f} s {tag}", flush=True)
    print(f"[window_full] peak device memory {peak / 2**30:.3f} GiB; "
          f"dot-product <M p, M p> vs <p, M^T M p> relative error "
          f"{rel:.3e} (float32); max|run_tl u| "
          f"{float(tl['u'].abs().max()):.4e} from max|p u| "
          f"{float(pert['u'].abs().max()):.4e} {tag}", flush=True)
    print("[window_full] host timers (FV3LM_TIMERS), both windows:",
          flush=True)
    timing.timing_prt()
    timing.timing_reset()
    del lm, trajs, pert, tl, ad
    memory_returned("window_full (saveltraj)", before, card)
    torch.cuda.empty_cache()

    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lm, trajs, pert, _ = window(False, 1)
    tl, t_tl = sync_time(lm.run_tl, trajs, pert)
    ad, t_ad = sync_time(lm.run_ad, trajs, tl)
    check(ad, "run_ad (saveltraj=False)", lm.prog_3d)
    print(f"[window_full] saveltraj=False, nt=1: run_tl {t_tl:.4f} s, run_ad "
          f"{t_ad:.4f} s (the step linearized again), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {tag}",
          flush=True)
    launches = sim1_solver_cuda.launches
    print(f"[window_full] SIM1 launches over the windows: {launches}",
          flush=True)
    if launches != 0:
        raise AssertionError(f"window: {launches} SIM1 launches on the "
                             "hydrostatic path")
    del lm, trajs, pert, tl, ad
    memory_returned("window_full (saveltraj=False)", before, card)
    torch.cuda.empty_cache()
    return launches


# ---- the decomposition: (face, y, x) tiles, one per rank (parallel/faces.py)

#: the transport of the card's ranks, and why
FACES_BACKEND = "gloo"
FACES_WHY = "gloo: the ranks share one GPU; NCCL needs one GPU per rank"
#: the layouts of phase_tiles_small: six faces (6, 1, 1), and (2, 2, 2):
#: three faces a rank, a quarter of each
TILES_SMALL_RANKS = (6, 8)
#: the layout of phase_tiles_full
TILES_FULL_RANKS = 8
#: the c96L72 float32 pair with the physics on eight ranks against one
#: process: each field's relative L2 difference (the AD's index_add sums
#: in another order on each rank; a float32 tape recorded per rank could
#: also differ at a tie)
TILES_FULL_TOL = 1e-5
#: the window of phase_tiles_small: c12L10 hydrostatic, nt=2, saveltraj
TILES_WINDOW_NT = 2
#: the cross-face entries of parallel/halo.py: (function, the staggers of
#: its fields ("c" a cell-center dimension, "b" a B-grid one, (y, x)),
#: levels (None: a 2-D field))
HALO_CASES = {
    "center": ("fill_halo_center", ("cc",), 4),
    "center_2d": ("fill_halo_center", ("cc",), None),
    "corner": ("fill_halo_corner", ("bb",), 4),
    "dgrid": ("fill_halo_dgrid", ("bc", "cb"), 4),
    "cgrid": ("fill_halo_cgrid", ("cb", "bc"), 4),
    "cgrid_scalar_pair": ("fill_halo_cgrid_scalar_pair", ("cb", "bc"), 4),
    "dgrid_scalar_pair": ("fill_halo_dgrid_scalar_pair", ("bc", "cb"), 4),
    "fix_shared_edges_dgrid": ("fix_shared_edges_dgrid", ("bc", "cb"), 3),
}

#: the script's deadline (time.monotonic()), set by main: every spawn of
#: ranks ends before it, so a hang is a named failure and not the
#: caller's kill
DEADLINE = None
#: seconds kept back before the deadline for the error's report
DEADLINE_SLACK = 20.0
#: the deadline, in seconds from the script's start
DEADLINE_S = 1100.0


def spawn_timeout(own, phase):
    """The timeout of a spawn in `phase`: `own`, or the time left before
    the script's deadline less DEADLINE_SLACK if that is shorter (raises
    if none is left)."""
    if DEADLINE is None:
        return own
    left = DEADLINE - time.monotonic() - DEADLINE_SLACK
    if left <= 0:
        raise TimeoutError(f"{phase}: the script's deadline of {DEADLINE_S} "
                           "s has passed")
    return min(own, left)


def spawn(phase, fn, *args, ranks, timeout):
    """run_faces(fn, *args) on `ranks` ranks on the card, its timeout cut
    to the script's deadline; a rank that fails or hangs raises naming
    `phase` (and run_faces names the rank)."""
    from fv3jedi_lm_tpu_torch.parallel.faces import run_faces

    limit = spawn_timeout(timeout, phase)
    try:
        return run_faces(fn, *args, backend=FACES_BACKEND, device="cuda",
                         timeout=limit, ranks=ranks)
    except (TimeoutError, RuntimeError) as e:
        raise type(e)(f"{phase} ({ranks} ranks, timeout {limit:.0f} s): "
                      f"{e}") from None


def halo_inputs(npx, seed):
    """For each case of HALO_CASES, whole-cube float64 (inputs, tangents,
    cotangents), each a list with one array per field; then "g_sum": a
    (6, n, n) field, a positive area, a tangent."""
    from fv3jedi_lm_tpu_torch import NG

    n = npx - 1
    dims = {"c": n + 2 * NG, "b": n + 1 + 2 * NG}
    rng = np.random.default_rng(seed)
    out = {}
    for name, (_, stags, nlev) in HALO_CASES.items():
        shapes = [((nlev,) if nlev else ()) + (6, dims[s[0]], dims[s[1]])
                  for s in stags]
        out[name] = [[rng.standard_normal(sh) for sh in shapes]
                     for _ in range(3)]
    out["g_sum"] = [rng.standard_normal((6, n, n)),
                    1.0 + rng.random((6, n, n)),
                    rng.standard_normal((6, n, n))]
    return out


def halo_owner(faces, n, shape):
    """Whether each point of a rank's window of a padded (..., 6, J, I)
    field is the rank's in the partition of the whole padded cube that
    gives each point to one tile: the tile whose cells (or staggered
    lines, a shared one to the north / east tile) hold it, a face halo
    point to the nearest tile.  A bool array of the window's last two
    dims with the rank's faces."""
    from fv3jedi_lm_tpu_torch import NG
    from fv3jedi_lm_tpu_torch.parallel.faces import split_faces

    _, y, x = faces.layout
    tile = faces.tile(n)
    J, I = shape[-2:]
    rj = np.arange(J) - NG
    ri = np.arange(I) - NG
    ty = np.clip(rj // tile.ny, 0, y - 1)
    tx = np.clip(ri // tile.nx, 0, x - 1)
    mine = ((ty == faces.ty)[:, None] & (tx == faces.tx)[None, :])
    whole = np.broadcast_to(mine, (6, J, I))
    return split_faces({"x": whole}, faces, n)["x"]


def halo_results(topo, inputs, device, faces=None):
    """Each cross-face entry of parallel/halo.py on `topo` at
    halo_inputs' numbers: its outputs ("<case>/fwd/<i>"), the jvp of the
    tangents ("/jvp/") and the vjp of the cotangents ("/vjp/"); then
    g_sum in modes 0 and 1, its value, jvp and gradient (of a cotangent
    1 given on one rank: each rank holds the sum, and its cotangent is
    the ranks' summed).  On one process `topo` is the CubeTopology; on a
    rank of a decomposition it is the rank's FaceTopology, `faces` its
    FaceGroup, and each whole-cube input is cut to the rank's window; a
    cotangent is given on the points the rank holds in halo_owner's
    partition only (elsewhere a point of the window is another rank's or
    a copy).  Numpy arrays of the rank's window, floats for the sums."""
    from fv3jedi_lm_tpu_torch.ops.reductions import g_sum, global_area
    from fv3jedi_lm_tpu_torch.parallel import halo
    from fv3jedi_lm_tpu_torch.parallel.faces import split_faces

    n = topo.n

    def own(a, cot=False):
        if faces is not None:
            part = split_faces({"x": a}, faces, n)["x"]
            if cot:
                part = part * halo_owner(faces, n, a.shape)
            a = part
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    res = {}
    for name, (fn, _, _) in HALO_CASES.items():
        def f(*xs, fn=fn):
            out = getattr(halo, fn)(*xs, topo)
            return tuple(out) if isinstance(out, tuple) else (out,)

        xs, ts = ([own(a) for a in group] for group in inputs[name][:2])
        ws = [own(a, cot=True) for a in inputs[name][2]]
        outs = f(*xs)
        tans = torch.func.jvp(f, tuple(xs), tuple(ts))[1]
        xg = [x.clone().requires_grad_() for x in xs]
        cots = torch.autograd.grad(f(*xg), xg, ws)
        for tag, vals in (("fwd", outs), ("jvp", tans), ("vjp", cots)):
            for i, v in enumerate(vals):
                res[f"{name}/{tag}/{i}"] = v.detach().cpu().numpy()
        if faces is not None:
            # the adjoint identity over the ranks, each rank's share
            res[f"{name}/lhs"] = faces.all_sum(sum(
                float((t * w).sum()) for t, w in zip(tans, ws)))
            res[f"{name}/rhs"] = faces.all_sum(sum(
                float((t * c).sum()) for t, c in zip(ts, cots)))
    p, area, t = (own(a) for a in inputs["g_sum"])
    # the sum's cotangent 1, given once: on one rank of a decomposition
    seed = torch.tensor(float(faces is None or faces.rank == 0),
                        dtype=p.dtype, device=device)
    total = global_area(area, faces=faces)     # mode 1's divisor, once
    for mode in (0, 1):
        def gs(x, mode=mode):
            return g_sum(x, area, mode, faces=faces, total=total)

        res[f"g_sum/{mode}/value"] = float(gs(p))
        res[f"g_sum/{mode}/jvp"] = float(torch.func.jvp(gs, (p,), (t,))[1])
        pg = p.clone().requires_grad_()
        res[f"g_sum/{mode}/grad"] = torch.autograd.grad(
            gs(pg), pg, seed)[0].cpu().numpy()
    return res


def faces_halos(faces, npx, seed):
    """A rank's halo_results at (npx, seed) on its FaceTopology, and
    parallel/ppermute's exchange of the center cases ("ppermute/<case>");
    with the rank's exchange count."""
    from fv3jedi_lm_tpu_torch.grid.topology import get_topology
    from fv3jedi_lm_tpu_torch.parallel.faces import FaceTopology, split_faces
    from fv3jedi_lm_tpu_torch.parallel.ppermute import (
        fill_halo_center_ppermute)

    topo = FaceTopology(get_topology(npx), faces)
    inputs = halo_inputs(npx, seed)
    res = halo_results(topo, inputs, faces.device, faces)
    for name in ("center", "center_2d"):
        q = split_faces({"x": inputs[name][0][0]}, faces, npx - 1)["x"]
        res[f"ppermute/{name}"] = fill_halo_center_ppermute(
            torch.as_tensor(q, device=faces.device), topo, faces
        ).cpu().numpy()
    res["exchanges"] = faces.exchanges
    return res


def join_results(parts):
    """The ranks' result dicts with their arrays joined into the whole
    cube (parallel/faces.join_faces) and their other values (sums over
    the ranks, counts) from rank 0."""
    from fv3jedi_lm_tpu_torch.parallel.faces import join_faces

    arrays = [{k: v for k, v in p.items() if isinstance(v, np.ndarray)}
              for p in parts]
    out = join_faces(arrays)
    for k, v in parts[0].items():
        if not isinstance(v, np.ndarray):
            out[k] = v
    return out


def check_tile_halos(parts, want, inputs, npx, tag, cases=None):
    """faces_halos' results of every rank against halo_results' single-
    process ones, window by window, for the HALO_CASES `cases` (all, and
    g_sum and ppermute, when None): outputs, jvps, ppermute and g_sum's
    value, jvp and gradient bitwise; the vjps, summed over the ranks'
    copies of each point, to 1e-14 relative (the transpose adds in
    another order); <E t, w> == <t, E^T w> over the ranks to 1e-14."""
    from fv3jedi_lm_tpu_torch.parallel.faces import (FaceGroup, split_faces,
                                                     window_index)

    world = len(parts)
    groups = [FaceGroup(r, FACES_BACKEND, "cpu", world) for r in range(world)]
    n = npx - 1
    names = list(HALO_CASES) if cases is None else list(cases)
    if cases is not None:
        want = {k: v for k, v in want.items() if k.split("/")[0] in names}
    for k, w in want.items():
        if isinstance(w, float):
            for r, p in enumerate(parts):
                if p[k] != w:
                    raise AssertionError(f"{tag} {k} rank {r}: {p[k]} != "
                                         f"one process's {w}")
            continue
        if "/vjp/" in k:
            # the whole cube's cotangent of a point is the sum over the
            # ranks' copies of it (a line two tiles share has two)
            joined = np.zeros_like(w)
            for g, p in zip(groups, parts):
                joined[window_index(w.shape, g, n)] += p[k]
            rel = _rel(joined, w)
            if not rel <= 1e-14:
                raise AssertionError(f"{tag} {k}: |tiles-one|/|one| = {rel} "
                                     "> 1e-14")
            continue
        for r, (g, p) in enumerate(zip(groups, parts)):
            cut = split_faces({"x": w}, g, n)["x"]
            if not np.array_equal(p[k], cut):
                raise AssertionError(f"{tag} {k} rank {r}: not bitwise "
                                     "equal to one process")
    for r, (g, p) in enumerate(zip(groups, parts)):
        for name in ("center", "center_2d"):
            if name not in names:
                continue
            cut = split_faces({"x": want[f"{name}/fwd/0"]}, g, n)["x"]
            if not np.array_equal(p[f"ppermute/{name}"], cut):
                raise AssertionError(f"{tag} ppermute {name} rank {r}: not "
                                     "bitwise equal to fill_halo_center")
    for name in names:
        lhs, rhs = parts[0][f"{name}/lhs"], parts[0][f"{name}/rhs"]
        if not abs(lhs - rhs) <= 1e-14 * abs(lhs):
            raise AssertionError(f"{tag} {name}: <E t, w> {lhs} != "
                                 f"<t, E^T w> {rhs}")


def faces_steps(faces, cases):
    """One rank of a decomposition of LinearModel, for each case (kw, dt,
    traj, dx, dy) of `cases`: a model at DynConfig(**kw), dt, on its part
    of the whole-cube numpy `traj`, `dx`, `dy`, then step_nl(traj),
    step_tl(traj, dx), step_ad(traj, dy).  Returns for each case its
    part of the outputs (numpy), <tl, dy> and <dx, ad> summed over the
    ranks (each over the lines it owns, lm.owned), its SIM1 launches and
    its exchanges."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_from_numpy
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
    from fv3jedi_lm_tpu_torch.parallel.faces import split_faces

    out = []
    for kw, dt, traj, dx, dy in cases:
        lm = LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=dt),
                                device=faces.device, faces=faces)
        tr, p, q = (traj_from_numpy(lm, split_faces(d, faces))
                    for d in (traj, dx, dy))
        sim1_solver_cuda.launches = 0
        faces.reset_counters()
        nl = lm.step_nl(tr)
        tl = lm.step_tl(tr, p)
        ad = lm.step_ad(tr, q)
        keys = lm.prog_3d
        out.append(dict(
            {f"{what}/{k}": d[k].detach().cpu().numpy()
             for what, d in (("nl", nl), ("tl", tl), ("ad", ad))
             for k in keys},
            lhs=faces.all_sum(dot(lm.owned(tl), lm.owned(q), keys)),
            rhs=faces.all_sum(dot(lm.owned(p), lm.owned(ad), keys)),
            launches=sim1_solver_cuda.launches, exchanges=faces.exchanges))
    return out


def tiles_phys(faces, cases):
    """One rank of a decomposition with the physics: for each moist mode
    of `cases` {mode: (traj, dx, dy) whole-cube numpy}, a model at
    PHYS_SMALL_KW with the turbulence and that mode on its part, then
    step_nl, step_tl, step_ad and the identity over the ranks, as
    faces_steps."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_from_numpy
    from fv3jedi_lm_tpu_torch.parallel.faces import split_faces

    out = {}
    for mode, (traj, dx, dy) in cases.items():
        cfg = LMConfig(dyn=DynConfig(**PHYS_SMALL_KW), dt=450.0,
                       do_phy_trb=True, do_phy_mst=mode)
        lm = LinearModel.create(cfg, device=faces.device, faces=faces,
                                ak=PHYS_AK, bk=PHYS_BK)
        tr, p, q = (traj_from_numpy(lm, split_faces(d, faces))
                    for d in (traj, dx, dy))
        nl = lm.step_nl(tr)
        tl = lm.step_tl(tr, p)
        ad = lm.step_ad(tr, q)
        keys = lm.prog_3d
        out[mode] = dict(
            {f"{what}/{k}": d[k].detach().cpu().numpy()
             for what, d in (("nl", nl), ("tl", tl), ("ad", ad))
             for k in keys},
            lhs=faces.all_sum(dot(lm.owned(tl), lm.owned(q), keys)),
            rhs=faces.all_sum(dot(lm.owned(p), lm.owned(ad), keys)))
    return out


def window_cfg(kw):
    """The window of phase_tiles_small and tests/test_torch_tiles.py at
    the configuration `kw`: TILES_WINDOW_NT steps, saveltraj."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig

    return LMConfig(dyn=DynConfig(**kw), dt=450.0, nt=TILES_WINDOW_NT,
                    saveltraj=True)


def window_run(lm, traj, dx, faces=None):
    """run_nl(traj), run_tl(trajs, dx) and run_ad(trajs, run_tl) of the
    window model `lm` on whole-cube numpy `traj` and `dx` (cut to the
    rank's part on a decomposition): the last state, the TL, the AD
    (numpy), <tl, tl> and <dx, ad> (summed over the ranks, each over the
    lines it owns, in one all_reduce) and the bytes of the rank's cached
    steps (debug.cache_bytes)."""
    from fv3jedi_lm_tpu_torch import debug
    from fv3jedi_lm_tpu_torch.lm import traj_from_numpy
    from fv3jedi_lm_tpu_torch.parallel.faces import split_faces

    if faces is not None:
        traj, dx = (split_faces(d, faces) for d in (traj, dx))
    tr, p = traj_from_numpy(lm, traj), traj_from_numpy(lm, dx)
    trajs = lm.run_nl(tr)
    tl = lm.run_tl(trajs, p)
    ad = lm.run_ad(trajs, tl)
    keys = lm.prog_3d
    lhs = dot(lm.owned(tl), lm.owned(tl), keys)
    rhs = dot(lm.owned(p), lm.owned(ad), keys)
    if faces is not None:
        lhs, rhs = faces.all_sum(lhs, rhs)
    return dict(
        {f"{what}/{k}": d[k].detach().cpu().numpy()
         for what, d in (("nl", trajs[-1]), ("tl", tl), ("ad", ad))
         for k in keys},
        lhs=lhs, rhs=rhs,
        cached=sum(sum(b) for b in debug.cache_bytes(lm)))


def tiles_window(faces, kw, traj, dx):
    """One rank of the window at `kw` (window_cfg) on a decomposition."""
    from fv3jedi_lm_tpu_torch.lm import LinearModel

    lm = LinearModel.create(window_cfg(kw), device=faces.device, faces=faces)
    return window_run(lm, traj, dx, faces)


def tiles_small(faces, npx, seed, cases, phys, window):
    """One rank of phase_tiles_small's spawn: faces_halos, faces_steps on
    `cases`, and where given the physics pair (tiles_phys on `phys`) and
    the window (`window` (kw, traj, dx))."""
    out = dict(halos=faces_halos(faces, npx, seed),
               steps=faces_steps(faces, cases))
    if phys:
        out["phys"] = tiles_phys(faces, phys)
    if window:
        out["window"] = tiles_window(faces, *window)
    return out


def perts_numpy(kw, seeds=(1, 2)):
    """rand_pert at `seeds` for the configuration `kw`, whole cube, numpy
    (from a model on the CPU)."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import LinearModel, traj_to_numpy

    lm = LinearModel.create(LMConfig(dyn=DynConfig(**kw), dt=450.0),
                            device="cpu")
    return [traj_to_numpy(rand_pert(lm, s)) for s in seeds]


def _rel(got, want):
    """|got - want| / |want| in the L2 norm, in float64."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def start_tiles_small(small):
    """Start phase_tiles_small's spawns, both layouts at once, in threads:
    tiles_small on every rank of TILES_SMALL_RANKS, on phase_tlad_small's
    trajectories (`small`) and phys_case's inputs.  Returns the pool,
    the jobs and the inputs, for phase_tiles_small."""
    npx = TLAD_SMALL["hydrostatic"]["npx"]
    cases = [(kw, 450.0, small[name][0], *perts_numpy(kw))
             for name, kw in TLAD_SMALL.items()]
    case = phys_case()
    phys = {mode: case for mode in (1, 2)}
    wkw = TLAD_SMALL["hydrostatic"]
    window = (wkw, small["hydrostatic"][0], perts_numpy(wkw, (3,))[0])
    last = TILES_SMALL_RANKS[-1]
    pool = ThreadPoolExecutor(len(TILES_SMALL_RANKS))
    jobs = {ranks: pool.submit(
        spawn, f"tiles_small {ranks} ranks", tiles_small, npx, 7, cases,
        phys if ranks == last else None, window if ranks == last else None,
        ranks=ranks, timeout=360.0) for ranks in TILES_SMALL_RANKS}
    return dict(pool=pool, jobs=jobs, window=window, phys=case,
                t0=time.perf_counter())


def phase_tiles_small(card, started, small, phys_one):
    """The decomposition on the card (gloo), float64, in the layouts
    TILES_SMALL_RANKS: (6, 1, 1), one face a rank, and (2, 2, 2), three
    faces a rank and a quarter of each, their spawns started by
    start_tiles_small (`started`).  In each, at c12: every exchange, its
    jvp and g_sum bitwise the single process's on the card, the vjp and
    the adjoint identity to 1e-14 (check_tile_halos); step_nl, step_tl
    and step_ad at c12L10, hydrostatic and nonhydrostatic, on
    phase_tlad_small's trajectories (`small`), within 1e-12 of one card
    process and 1e-10 of the CPU, the dot-product identity over the ranks
    below 1e-12 and SIM1 launched on every nonhydrostatic rank.  On
    (2, 2, 2) also the physics pair at PHYS_SMALL_KW, modes 1 and 2,
    against phase_phys_small's card results (`phys_one`, on the same
    inputs), and the window (window_cfg, nt 2, saveltraj) against one
    card process, each within 1e-12.  Returns the SIM1 launches of each
    NH rank of (2, 2, 2)."""
    from fv3jedi_lm_tpu_torch.grid.topology import get_topology
    from fv3jedi_lm_tpu_torch.lm import LinearModel
    from fv3jedi_lm_tpu_torch.parallel.faces import layout

    print(f"[tiles_small] {FACES_WHY}", flush=True)
    tag = f"({card[0]}; {card[1]})"
    npx = TLAD_SMALL["hydrostatic"]["npx"]
    last = TILES_SMALL_RANKS[-1]
    wkw, wtraj, wdx = started["window"]
    inputs = halo_inputs(npx, 7)
    want_halos = halo_results(get_topology(npx), inputs, "cuda")
    one = LinearModel.create(window_cfg(wkw))
    want_window = window_run(one, wtraj, wdx)
    del one
    with started["pool"]:
        done = {ranks: job.result() for ranks, job in started["jobs"].items()}
    print(f"[tiles_small] the spawns of {TILES_SMALL_RANKS} ranks at once: "
          f"{time.perf_counter() - started['t0']:.1f} s from their start",
          flush=True)
    for mode, r in phys_one.items():
        if any(not np.array_equal(a[k], b[k]) for a, b in zip(
                r["case"], started["phys"]) for k in a):
            raise AssertionError("tiles_small: the physics inputs differ "
                                 f"from phase_phys_small's (mode {mode})")
    launches = None
    for ranks in TILES_SMALL_RANKS:
        results = done[ranks]
        lay = results[0]["halos"]
        name_l = f"{ranks} ranks {layout(ranks)}"
        check_tile_halos([r["halos"] for r in results], want_halos, inputs,
                         npx, f"tiles_small {name_l}")
        print(f"[tiles_small] {name_l} c12: {len(HALO_CASES)} exchanges, "
              "their jvp, ppermute's center exchange and g_sum bitwise equal "
              "to one process on the card; vjp and the adjoint identity "
              f"within 1e-14; {lay['exchanges']} exchanges a rank {tag}",
              flush=True)
        for i, (name, kw) in enumerate(TLAD_SMALL.items()):
            parts = [r["steps"][i] for r in results]
            got = join_results(parts)
            ref = small[name][1]
            worst = check_steps(got, ref["cuda"], f"tiles_small {name_l} "
                                f"{name}", 1e-12)
            worst_cpu = check_steps(got, ref["cpu"], f"tiles_small {name_l} "
                                    f"{name} (CPU)", 1e-10)
            rel = abs(got["lhs"] - got["rhs"]) / max(abs(got["lhs"]), 1e-300)
            by_rank = [p["launches"] for p in parts]
            print(f"[tiles_small] {name_l} {name}: max over fields of "
                  "|tiles-one|/|one| against one process on the card "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                  + ", on the CPU "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst_cpu.items())
                  + f"; dot-product identity over the ranks {rel:.3e}; "
                  f"exchanges a rank {parts[0]['exchanges']}; SIM1 launches "
                  f"by rank {by_rank}", flush=True)
            if not rel < 1e-12:
                raise AssertionError(f"tiles_small {name_l} {name}: "
                                     f"dot-product identity {rel} >= 1e-12")
            if not kw.get("hydrostatic", True):
                if not all(n > 0 for n in by_rank):
                    raise AssertionError(
                        f"tiles_small {name_l} {name}: SIM1 launches by rank "
                        f"{by_rank}, want > 0 on every rank")
                launches = by_rank
        if ranks == last:
            for mode, r in phys_one.items():
                got = join_results([x["phys"][mode] for x in results])
                worst = check_steps(got, r, f"tiles_small {name_l} physics "
                                    f"mode {mode}", 1e-12)
                rel = abs(got["lhs"] - got["rhs"]) / max(abs(got["lhs"]),
                                                         1e-300)
                print(f"[tiles_small] {name_l} c8L12 turbulence + moist mode "
                      f"{mode}: max over fields of |tiles-one|/|one| "
                      + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                      + f"; dot-product identity over the ranks {rel:.3e}",
                      flush=True)
                if not rel < 1e-12:
                    raise AssertionError(f"tiles_small physics mode {mode}: "
                                         f"dot-product identity {rel}")
            got = join_results([x["window"] for x in results])
            want = {what: {k.split("/", 1)[1]: v
                           for k, v in want_window.items()
                           if k.startswith(f"{what}/")}
                    for what in ("nl", "tl", "ad")}
            worst = check_steps(got, want, f"tiles_small {name_l} window",
                                1e-12)
            rel = abs(got["lhs"] - got["rhs"]) / max(abs(got["lhs"]), 1e-300)
            cached = [x["window"]["cached"] for x in results]
            print(f"[tiles_small] {name_l} window c12L10 nt="
                  f"{TILES_WINDOW_NT} saveltraj: run_nl, run_tl, run_ad max "
                  "over fields of |tiles-one|/|one| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                  + f"; window dot-product identity over the ranks "
                  f"{rel:.3e} (one process {abs(want_window['lhs'] - want_window['rhs']) / abs(want_window['lhs']):.3e}); "
                  f"cached bytes by rank {cached} (one process "
                  f"{want_window['cached']})", flush=True)
            if not rel < 1e-12:
                raise AssertionError(f"tiles_small window: dot-product "
                                     f"identity {rel}")
    return launches


def check_steps(got, want, tag, tol):
    """A decomposition's joined results against one process's (dicts nl,
    tl, ad of numpy fields): every field finite and within `tol` relative
    in norm.  Returns the worst relative difference of each sweep."""
    worst = {}
    for what in ("nl", "tl", "ad"):
        worst[what] = 0.0
        for k, w in want[what].items():
            g = got[f"{what}/{k}"]
            if not np.isfinite(g).all():
                raise AssertionError(f"{tag} {what} {k}: not finite")
            r = _rel(g, w)
            worst[what] = max(worst[what], r)
            if not r <= tol:
                raise AssertionError(f"{tag} {what} {k}: |tiles-one|/|one| "
                                     f"= {r} > {tol}")
    return worst


def tiles_full_pair(faces, pairs, card, traj, pert):
    """One rank of the c96L72 float32 pair with the turbulence and moist
    mode 1 (TLAD_FULL_KW, phase_phys_full's configuration) on its part of
    _phys_full_case's whole-cube `traj` and `pert` (numpy): a first pair
    (the forward, record and both physics linearizations timed apart),
    then `pairs` warm pairs, each timed to a synchronize of this rank and
    then to a barrier of all (the slowest rank's time); the rank's peak
    memory, exchanges, bytes and host seconds inside exchanges per warm
    pair; its SIM1 launches over all the pairs (0: hydrostatic); its part
    of the last pair's tl and ad (numpy).  After the model is dropped its
    device memory must come back (memory_returned)."""
    from fv3jedi_lm_tpu_torch.config import DynConfig, LMConfig
    from fv3jedi_lm_tpu_torch.lm import (LinearModel, traj_from_numpy,
                                         traj_to_numpy)
    from fv3jedi_lm_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
    from fv3jedi_lm_tpu_torch.parallel.faces import split_faces

    cfg = LMConfig(dyn=DynConfig(**TLAD_FULL_KW), dt=FULL_DT,
                   do_phy_trb=True, do_phy_mst=1)
    before = _allocated()
    torch.cuda.reset_peak_memory_stats()
    lm = LinearModel.create(cfg, device=faces.device, faces=faces)
    traj = traj_from_numpy(lm, split_faces(traj, faces))
    pert = traj_from_numpy(lm, split_faces(pert, faces))
    stepper = lm._staged()
    parts = {}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            return out
        return run

    stepper.forward = timed("forward", stepper.forward)
    stepper.record = timed("record", stepper.record)
    lm._moist.linearize = timed("moist", lm._moist.linearize)
    lm._turb_ltraj = timed("turb", lm._turb_ltraj)

    def pair():
        faces.barrier()
        faces.reset_counters()
        t0 = time.perf_counter()
        tl = lm.step_tl(traj, pert)
        ad = lm.step_ad(traj, tl)
        torch.cuda.synchronize()
        own = time.perf_counter() - t0
        faces.barrier()
        return tl, ad, dict(own=own, all=time.perf_counter() - t0,
                            exchanges=faces.exchanges,
                            bytes=faces.bytes_sent,
                            exchange_s=faces.seconds)

    sim1_solver_cuda.launches = 0
    tl, ad, first = pair()
    first.update(parts)
    warm = []
    for _ in range(pairs):
        tl, ad, t = pair()
        warm.append(t)
    del stepper.forward, stepper.record, lm._moist.linearize, lm._turb_ltraj
    out = dict(first=first, warm=warm, peak=torch.cuda.max_memory_allocated(),
               launches=sim1_solver_cuda.launches,
               **{f"tl/{k}": v for k, v in traj_to_numpy(tl).items()},
               **{f"ad/{k}": v for k, v in traj_to_numpy(ad).items()})
    del lm, traj, pert, tl, ad, stepper
    memory_returned(f"tiles_full rank {faces.rank}", before, card)
    return out


def phase_tiles_full(card, ref, pairs=2):
    """TILES_FULL_RANKS ranks on the card (gloo) in the layout (2, 2, 2)
    at c96L72 float32 with the turbulence and moist mode 1 on
    phase_phys_full's inputs (`ref`: its traj, pert and last pair, numpy;
    tiles_full_pair), against that last pair: every field finite, each
    field's relative L2 difference at most TILES_FULL_TOL, no SIM1 launch
    on any rank (hydrostatic), and every rank's device memory back once
    its model is dropped.  Returns the SIM1 launches by rank."""
    from fv3jedi_lm_tpu_torch.parallel.faces import layout

    ranks = TILES_FULL_RANKS
    print(f"[tiles_full] {FACES_WHY}", flush=True)
    parts = spawn("tiles_full", tiles_full_pair, pairs, card, ref["traj"],
                  ref["pert"], ranks=ranks, timeout=300.0)
    got = join_results(parts)
    tag = f"({card[0]}; {card[1]})"
    first = [p["first"] for p in parts]
    lay = f"{ranks} ranks {layout(ranks)}"
    print(f"[tiles_full] c96L72 hydrostatic f32, turbulence + moist mode 1, "
          f"{lay} on one card: first pair "
          f"{max(f['all'] for f in first):.4f} s (slowest rank; forward "
          f"{max(f['forward'] for f in first):.4f} s, record "
          f"{max(f['record'] for f in first):.4f} s, moist set_ltraj "
          f"{max(f['moist'] for f in first):.4f} s, turbulence set_ltraj "
          f"{max(f['turb'] for f in first):.4f} s) {tag}", flush=True)
    for i in range(pairs):
        w = [p["warm"][i] for p in parts]
        print(f"[tiles_full] warm pair {i + 1}: "
              f"{max(x['all'] for x in w):.4f} s to the barrier (slowest "
              "rank); by rank to its synchronize "
              + ", ".join(f"{x['own']:.4f}" for x in w) + " s; exchanges "
              f"a rank {w[0]['exchanges']}, MB sent by rank "
              + ", ".join(f"{x['bytes'] / 1e6:.1f}" for x in w)
              + "; host s inside exchanges by rank "
              + ", ".join(f"{x['exchange_s']:.3f}" for x in w) + f" {tag}",
              flush=True)
    launches = [p["launches"] for p in parts]
    print(f"[tiles_full] SIM1 launches by rank {launches}", flush=True)
    if any(launches):
        raise AssertionError(f"tiles_full: SIM1 launches by rank {launches} "
                             "on the hydrostatic path, want 0")
    print("[tiles_full] peak device memory by rank "
          + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in parts)
          + f" GiB, {sum(p['peak'] for p in parts) / 2**30:.3f} GiB in all "
          f"{tag}", flush=True)
    worst = 0.0
    for what in ("tl", "ad"):
        for k, w in ref[what].items():
            g = got[f"{what}/{k}"]
            if not np.isfinite(g).all():
                raise AssertionError(f"tiles_full {what} {k}: not finite")
            r = _rel(g, w)
            scale = max(float(np.abs(w).max()), 1e-30)
            d = np.abs(g.astype(np.float64) - w)
            print(f"[tiles_full] {what} {k}: |tiles-one|/|one| {r:.3e}, "
                  f"max|tiles-one|/max|one| {float(d.max()) / scale:.3e}",
                  flush=True)
            worst = max(worst, r)
            if not r <= TILES_FULL_TOL:
                raise AssertionError(f"tiles_full {what} {k}: |tiles-one|"
                                     f"/|one| = {r} > {TILES_FULL_TOL}")
    print(f"[tiles_full] worst field |tiles-one|/|one| {worst:.3e} (gate "
          f"{TILES_FULL_TOL})", flush=True)
    return launches


def run_phases(card, record, refs, elapsed):
    """The phases after the kernel's, in order; each model dropped must
    return its device memory.  Fills `record`'s launch counts."""
    phase_small(refs)
    before = _allocated()
    lm, last, record["launches"] = phase_full(card)
    phase_profile(lm, last)
    del lm, last
    memory_returned("NH step_nl", before, card)
    elapsed("NH step_nl")
    small = phase_tlad_small(refs)
    elapsed("tlad_small")
    refs.wait()     # no worker runs while the c96L72 phases are timed
    elapsed("CPU references")
    before = _allocated()
    (lm, traj, pert, best,
     record["launches_tlad_c96L72"]) = phase_tlad_full(card)
    phase_tlad_profile(lm, traj, pert, best)
    del lm, traj, pert
    memory_returned("tlad_full", before, card)
    torch.cuda.empty_cache()
    elapsed("tlad_full + profile")
    phys_one = phase_phys_small(refs)
    elapsed("phys_small")
    before = _allocated()
    (lm, traj, pert, best, record["launches_phys_c96L72"],
     phys_ref) = phase_phys_full(card)
    phase_phys_profile(lm, traj, pert, best)
    del lm, traj, pert
    memory_returned("phys_full", before, card)
    torch.cuda.empty_cache()
    elapsed("phys_full + profile")
    # the decomposition's small checks run beside the options' (neither
    # is timed), and both end before the next timed phase
    started = start_tiles_small(small)
    phase_options_small(refs)
    elapsed("options_small")
    record["launches_tiles_nh_by_rank"] = phase_tiles_small(
        card, started, small, phys_one)
    elapsed("tiles_small")
    record["launches_window_c96L72"] = phase_window_full(card)
    elapsed("window_full")
    record["launches_tiles_c96L72_by_rank"] = phase_tiles_full(card,
                                                               phys_ref)
    elapsed("tiles_full")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global DEADLINE
    _cpu_worker()
    t_start = time.perf_counter()
    DEADLINE = time.monotonic() + DEADLINE_S

    def elapsed(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    card = _card()
    print(f"[device] {card[0]}", flush=True)
    print(card[1], flush=True)
    phase_build()
    record = phase_kernel(card)
    phase_tapes(card)
    elapsed("kernel, tapes")
    # the CPU halves of the small phases from here on run in workers,
    # after the kernel's timings and before the c96L72 ones
    refs = CpuReferences()
    try:
        submit_cpu_references(refs)
        run_phases(card, record, refs, elapsed)
    finally:
        refs.close()
    print(card[1], flush=True)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
