"""The one traffic generator: a configuration's trajectory and a traffic
mix's perturbations, made on the device from `--seed`.

The recipes are copies of `chip_smoke.py`'s input generators (as of
commit 0fe27a5), kept here so that a change to the program cannot change
the yardstick: `spun_up`'s smooth thermal bump with moisture (`_bump`,
`_moisten`, `spun_up`), `_phys_full_case`'s convective sounding
(`moist_traj`) and exchange fields (`turb_sfc`), and `rand_pert` with its
`PERT_SCALE`.  Where those drew from numpy on the host, these draw the
same distributions from a `torch.Generator` on the device, in one call a
distribution, and the bump's phases and amplitude come from the seed.

A configuration file's `trajectory` block names its recipe (`bump`,
`convective`); a traffic file names how many trajectories and
perturbations a run cycles through.  Everything here is a pure function of
(configuration, traffic, seed, device): the harness calls it in set-up and
again after the window, for the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fvref.grid.eta import default_ak_bk

TRACERS = ("qv", "ql", "qi", "o3")
#: the 2-D surface fields a trajectory carries (zero unless the recipe
#: sets them)
SURFACE_2D = ("frland", "frocean", "varflt", "zpbl", "cm", "ct", "cq",
              "ustar", "bstar", "ts", "kcbl", "khl", "khu")
#: chip_smoke.PERT_SCALE: the perturbation scales of tests/test_lm.py,
#: tests/test_nh_e2e.py and tests/test_moist.py `_rand_pert`
PERT_SCALE = dict(u=1.0, v=1.0, t=1.0, delp=10.0, qv=1e-4, ql=1e-6,
                  qi=1e-6, o3=1e-7, w=0.1, delz=1.0, cfcn=1e-3)


def ak_bk(conf):
    """The configuration's ak/bk: its own, or the reference's L(npz)."""
    m = conf["model"]
    if "ak" in m:
        return np.asarray(m["ak"], np.float64), np.asarray(m["bk"],
                                                           np.float64)
    return default_ak_bk(m["dyn"]["npz"], ptop=m["dyn"].get("ptop", 1.0))


def prog_fields(conf):
    """The prognostic 3-D fields of the configuration's states."""
    m = conf["model"]
    return ("u", "v", "t", "delp") + TRACERS + (
        ("cfcn",) if m.get("do_phy_mst", 0) else ())


def _shape(conf, name):
    dyn = conf["model"]["dyn"]
    n, npz = dyn["npx"] - 1, dyn["npz"]
    return (npz, 6, n + (name == "u"), n + (name == "v"))


def _gen(seed, device, stream):
    """A generator on `device` for one stream of draws of `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def rest(conf, dtype, device, t0=280.0, ps0=1.0e5):
    """The resting isothermal state of LinearModel.rest_traj (hydrostatic),
    with every surface field zero."""
    dyn = conf["model"]["dyn"]
    n, npz = dyn["npx"] - 1, dyn["npz"]
    ak, bk = ak_bk(conf)
    pe = ak + bk * ps0
    z3 = lambda name: torch.zeros(_shape(conf, name), dtype=dtype,
                                  device=device)
    tr = {k: z3(k) for k in prog_fields(conf)}
    tr["delp"] = torch.as_tensor(pe[1:] - pe[:-1], dtype=dtype,
                                 device=device)[:, None, None, None].expand(
        npz, 6, n, n).contiguous()
    tr["t"] = torch.full_like(tr["t"], t0)
    for f in ("phis",) + SURFACE_2D:
        tr[f] = torch.zeros((6, n, n), dtype=dtype, device=device)
    return tr


def _grid_ijk(n, npz, device):
    ar = lambda m: torch.arange(m, dtype=torch.float64, device=device)
    jj = ar(n)[:, None]
    ii = ar(n)[None, :]
    faces = ar(6)[:, None, None]
    ks = ar(npz)[:, None, None, None]
    return jj, ii, faces, ks


def bump_traj(conf, seed, dtype, device):
    """`spun_up`'s initial state (moist): rest plus the smooth thermal bump
    of tests/test_nh_e2e.py and the humidity of tests/test_lm.py, the
    bump's amplitude and the phases of both drawn from `seed`."""
    dyn = conf["model"]["dyn"]
    n, npz = dyn["npx"] - 1, dyn["npz"]
    rng = np.random.default_rng(int(seed))
    amp = 3.0 * (0.75 + 0.5 * rng.random())
    ph = 2.0 * math.pi * rng.random(3)
    jj, ii, faces, ks = _grid_ijk(n, npz, device)
    b = (amp * torch.sin(2.0 * math.pi * (jj + 0.5) / n + 0.7 * faces + ph[0])
         * torch.cos(2.0 * math.pi * (ii + 0.5) / n + 0.3 * faces + ph[1])
         * torch.cos(0.5 * math.pi * ks / npz))
    qv = 1e-3 * (1.0 + torch.sin(2.0 * math.pi * (ii + jj) / n + faces
                                 + ph[2])) * torch.ones_like(ks)
    tr = rest(conf, dtype, device)
    tr["t"] = tr["t"] + b.to(dtype)
    tr["qv"] = tr["qv"] + qv.to(dtype)
    return tr


def convective_traj(conf, seed, dtype, device):
    """`_phys_full_case`'s trajectory: rest with tests/test_moist.py's
    convective sounding (`moist_traj`: a cold top, a warm moist surface
    with noise, ts, a random land mask, the cloud base at the lowest
    level, condensate and convective cloud on a Gaussian profile at 0.7
    npz), frocean = 1 - frland, and tests/test_turbulence.py's exchange
    fields (`turb_sfc`), all drawn from `seed` on the device."""
    dyn = conf["model"]["dyn"]
    n, npz = dyn["npx"] - 1, dyn["npz"]
    g = _gen(seed, device, 1)
    sh, s2 = (npz, 6, n, n), (6, n, n)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    N = lambda shape: torch.randn(shape, **f64)
    U = lambda shape: torch.rand(shape, **f64)
    ks = torch.arange(npz, dtype=torch.float64,
                      device=device)[:, None, None, None]
    tr = rest(conf, dtype, device)
    c = lambda x: x.to(dtype)
    tr["t"] = c(225.0 + 75.0 * (ks / (npz - 1.0)) ** 1.2 + 1.5 * N(sh))
    qv = 0.018 * torch.exp(-3.0 * (1.0 - ks / (npz - 1.0)))
    tr["qv"] = c(torch.clamp(qv * (1.0 + 0.2 * N(sh)), min=1e-7))
    tr["ts"] = c(305.0 + N(s2))
    tr["frland"] = c((U(s2) > 0.5) * 1.0)
    tr["kcbl"] = c(torch.full(s2, float(npz - 1), dtype=torch.float64,
                              device=device))
    prof = torch.exp(-0.5 * ((ks - 0.7 * npz) / (0.15 * npz)) ** 2)
    tr["qls"] = c(4e-5 * prof * (1.0 + 0.3 * U(sh)))
    tr["qcn"] = c(3e-5 * prof * (1.0 + 0.3 * U(sh)))
    tr["cfcn"] = c(0.1 * prof * torch.ones(sh, dtype=torch.float64,
                                           device=device))
    tr["ustar"] = c(0.2 + 0.1 * U(s2))
    tr["bstar"] = c(0.02 * N(s2))
    tr["cm"] = c(0.01 * U(s2))
    tr["ct"] = c(0.01 * U(s2))
    tr["cq"] = c(0.01 * U(s2))
    tr["frocean"] = 1.0 - tr["frland"]
    tr["varflt"] = c(100.0 * U(s2))
    tr["zpbl"] = c(500.0 + 500.0 * U(s2))
    return tr


RECIPES = {"bump": bump_traj, "convective": convective_traj}


def trajectories(conf, traffic, seed, dtype, device):
    """The traffic's `trajectories` initial states of the configuration's
    recipe, the i-th from seed + i: before the recipe's `nl_steps`
    nonlinear steps, which the caller takes (the program in set-up, the
    reference after the window)."""
    recipe = RECIPES[conf["trajectory"]["recipe"]]
    return [recipe(conf, int(seed) + i, dtype, device)
            for i in range(int(traffic.get("trajectories", 1)))]


def perturbations(conf, traffic, seed, dtype, device):
    """The traffic's `perturbations` perturbations: white noise times
    PERT_SCALE (rand_pert), each field of all of them in one draw."""
    n = int(traffic["perturbations"])
    g = _gen(seed, device, 2)
    out = [dict() for _ in range(n)]
    for k in prog_fields(conf):
        x = torch.randn((n,) + _shape(conf, k), dtype=dtype, device=device,
                        generator=g) * PERT_SCALE[k]
        for i in range(n):
            out[i][k] = x[i]
    return out


def checked_pair(traffic, seed):
    """The window pair whose outputs the reference judges: drawn from
    `seed` among the first `check_among` pairs, which every run reaches."""
    rng = np.random.default_rng([int(seed), 7])
    return int(rng.integers(int(traffic["check_among"])))
