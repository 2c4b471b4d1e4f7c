"""The plain reference of a TL+AD pair: the frozen copy `fvref` driven
without the port's checkpoints, tapes or pruning.

* `nl_step` is the nonlinear dynamics step (`fv_dynamics`).
* `linearize` runs the step's trajectory stages (prep, pre, each acoustic
  substep, post) forward once and keeps each one's input, the points at
  which the split linearization is taken; with the physics it makes the
  moist and turbulence linearizations at the post-dynamics and post-moist
  states.  Every branch decision is made afresh from the trajectory's
  values: no tape.
* `tl` chains, stage by stage, the `torch.func.jvp` of the stage's
  linearization target (the "mixed" stage: trajectory values,
  perturbation derivatives with the perturbation's own advection, remap
  and damping options) at the kept input, then the physics' jvps.
* `ad` is its transpose by autograd: the physics' vjps, then each stage's
  vjp at its kept input, last first.

It imports nothing of the port: the configuration's file, the
trajectory and the perturbation are all it takes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fvref import NG
from fvref.autodiff import vjp
from fvref.config import DynConfig, LMConfig
from fvref.constants import KAPPA
from fvref.core.dyn_core import acoustic_carry, make_acoustic_substep
from fvref.core.fv_dynamics import (fv_dynamics, post_acoustic_stage,
                                    pre_acoustic_stage, prep_stage,
                                    reference_pressure, reference_thickness)
from fvref.grid.device import to_device
from fvref.grid.eta import default_ak_bk
from fvref.grid.metrics import build_grid
from fvref.parallel import halo

TRACERS = ("qv", "ql", "qi", "o3")
SURFACE_2D = ("frland", "frocean", "varflt", "zpbl", "cm", "ct", "cq",
              "ustar", "bstar", "ts", "kcbl", "khl", "khu")
MOIST_3D = ("qls", "qcn", "cfcn")
PHYS_FIELDS = ("u", "v", "t", "qv", "qi", "ql", "o3")
DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def lm_config(conf: dict, dtype: str | None = None) -> LMConfig:
    """The LMConfig of a configuration file's `model` block; `dtype`
    overrides the stated precision (the control)."""
    m = conf["model"]
    dyn = dict(m["dyn"])
    if dtype is not None:
        dyn["dtype"] = dtype
    return LMConfig(dyn=DynConfig(**dyn).resolve(), dt=float(m["dt"]),
                    do_phy_trb=bool(m.get("do_phy_trb", False)),
                    do_phy_mst=int(m.get("do_phy_mst", 0)))


@dataclass
class Linearization:
    segments: list        # (mixed stage, its input on the trajectory)
    moist: dict | None    # the moist ltraj
    turb: dict | None     # the turbulence ltraj


class Reference:
    """The reference model of one configuration, on `device`, in the
    configuration's precision unless `dtype` names another."""

    def __init__(self, conf: dict, device, dtype: str | None = None):
        cfg = lm_config(conf, dtype)
        self.cfg = cfg
        dyn = cfg.dyn
        self.dtype = DTYPES[dyn.dtype]
        self.device = torch.device(device)
        self.tracers = TRACERS + (("cfcn",) if cfg.do_phy_mst else ())
        self.prog_3d = ("u", "v", "t", "delp") + self.tracers
        big = 1.0e30 if self.dtype == torch.float64 else 1.0e8
        gm = build_grid(dyn.npx, big=big)
        self.topo = gm.topo
        self.grid = to_device(gm, self.dtype, self.device)
        self.n = dyn.nx
        m = conf["model"]
        if "ak" in m:
            ak, bk = np.asarray(m["ak"], np.float64), np.asarray(m["bk"],
                                                                np.float64)
        else:
            ak, bk = default_ak_bk(dyn.npz, ptop=dyn.ptop)
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        self.ak = np.asarray(ak, np_dtype)
        self.bk = np.asarray(bk, np_dtype)
        self.ptop = float(ak[0])
        self._moist = self._turb = None
        if cfg.do_phy_trb:
            from fvref.physics.turbulence import Turbulence
            self._turb = Turbulence(dyn, self.ak, self.bk)
        if cfg.do_phy_mst:
            from fvref.physics.moist import Moist
            self._moist = Moist(dyn, self.ak, self.bk, cfg.dt,
                                cfg.do_phy_mst)
        mdt = cfg.dt / dyn.k_split
        self._mdt = mdt
        self._sub = {mode: make_acoustic_substep(
            self.grid, self.topo, dyn, mdt, KAPPA, self.ptop, dyn.npz,
            self.dtype, mode=mode, dp_ref=reference_thickness(ak, bk),
            pm=reference_pressure(ak, bk)) for mode in ("traj", "mixed")}

    # -- marshalling (the whole cube on one process) -------------------------

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def pad(self, prog):
        n, npz = self.n, self.cfg.dyn.npz

        def pad3(name, sy=0, sx=0):
            out = self._zeros(npz, 6, n + sy + 2 * NG, n + sx + 2 * NG)
            out[:, :, NG:NG + n + sy, NG:NG + n + sx] = prog[name].to(
                self.dtype)
            return out

        st = dict(u=pad3("u", sy=1), v=pad3("v", sx=1), pt=pad3("t"),
                  delp=pad3("delp"))
        st["u"], st["v"] = halo.fix_shared_edges_dgrid(st["u"], st["v"],
                                                       self.topo)
        st["w"] = self._zeros(npz, 6, n + 2 * NG, n + 2 * NG)
        return st, [pad3(name) for name in self.tracers]

    def unpad(self, st, q):
        n = self.n
        cy = cx = slice(NG, NG + n)
        by = bx = slice(NG, NG + n + 1)
        out = dict(u=st["u"][:, :, by, cx], v=st["v"][:, :, cy, bx],
                   t=st["pt"][:, :, cy, cx], delp=st["delp"][:, :, cy, cx])
        for name, qq in zip(self.tracers, q):
            out[name] = qq[:, :, cy, cx]
        return out

    def pad_phis(self, phis):
        n = self.n
        out = self._zeros(6, n + 2 * NG, n + 2 * NG)
        out[:, NG:NG + n, NG:NG + n] = phis.to(self.dtype)
        return halo.fill_halo_center(out, self.topo)

    def cast(self, d):
        return {k: v.to(self.dtype) for k, v in d.items()}

    # -- the nonlinear step ---------------------------------------------------

    @torch.no_grad()
    def nl_step(self, traj):
        """The nonlinear dynamics step of `traj` (no physics)."""
        if self.cfg.do_phy:
            raise NotImplementedError("nl_step: dynamics only")
        st, q = self.pad({k: traj[k] for k in self.prog_3d})
        st["phis"] = self.pad_phis(traj["phis"])
        st, q = fv_dynamics(st, q, self.grid, self.topo, self.cfg.dyn,
                            self.cfg.dt, self.ak, self.bk, self.ptop)
        return self.unpad(st, q)

    # -- the linearization target ---------------------------------------------

    def _segments(self, phis, mode):
        """The step as stage functions S -> S' of `mode` ("traj" or
        "mixed"), the first taking the compute-domain prognostic dict, the
        last returning it."""
        dyn = self.cfg.dyn
        grid, topo = self.grid, self.topo
        ak = torch.as_tensor(self.ak, dtype=self.dtype, device=self.device)
        bk = torch.as_tensor(self.bk, dtype=self.dtype, device=self.device)
        pm = reference_pressure(self.ak, self.bk)
        npz = dyn.npz

        def prep(prog):
            st, q = self.pad(prog)
            st["phis"] = self.pad_phis(phis)
            st, q = prep_stage(st, q, grid, topo, dyn, self.ptop)
            return dict(st=st, q=q)

        def pre(s):
            st2, dp1 = pre_acoustic_stage(s["st"], topo, dyn)
            return dict(st2=st2, dp1=dp1, q=s["q"],
                        carry=acoustic_carry(st2, dyn, npz))

        def sub(s):
            c = self._sub[mode](s["carry"], dict(phis=s["st2"]["phis"]))
            return dict(s, carry=c)

        def post(last):
            def f(s):
                st, q = post_acoustic_stage(
                    s["st2"], s["carry"], s["q"], s["dp1"], grid, topo, dyn,
                    ak, bk, pm, self.ptop, self._mdt, last, mode=mode)
                return dict(st=st, q=q)
            return f

        segs = [prep]
        for k in range(dyn.k_split):
            segs += [pre] + [sub] * dyn.n_split
            segs.append(post(k == dyn.k_split - 1))
        segs.append(lambda s: self.unpad(s["st"], s["q"]))
        return segs

    @torch.no_grad()
    def linearize(self, traj):
        """The stages' inputs on the trajectory and the physics
        linearizations of `traj`."""
        s = self.cast({k: traj[k] for k in self.prog_3d})
        kept = []
        for f, g in zip(self._segments(traj["phis"], "traj"),
                        self._segments(traj["phis"], "mixed")):
            kept.append((g, s))
            s = f(s)
        moist = turb = None
        if self._moist is not None:
            m = self._moist
            moist = m._ltraj(s, self._moist_sfc(traj))
            s = m._writeback(moist, s, m._moist_step(moist, m._x0(moist)))
        if self._turb is not None:
            turb = self._turb_ltraj(s, traj)
        return Linearization(kept, moist, turb)

    # -- the physics ----------------------------------------------------------

    def _cells(self):
        return (6, self.n, self.n)

    def _sfc(self, traj, names, shape):
        return {f: traj[f].to(self.dtype) if f in traj else self._zeros(*shape)
                for f in names}

    def _moist_sfc(self, traj):
        sfc = self._sfc(traj, ("ts", "frland", "kcbl", "khu", "khl"),
                        self._cells())
        sfc.update({f: traj[f].to(self.dtype) for f in MOIST_3D if f in traj})
        return sfc

    def _turb_ltraj(self, prog, traj):
        sfc = self._sfc(traj, SURFACE_2D, self._cells())
        sfc.update(self._sfc(traj, ("qls", "qcn"),
                             (self.cfg.dyn.npz,) + self._cells()))
        return self._turb.set_ltraj(dict(prog, **sfc), self.cfg.dt,
                                    do_phy_mst=self.cfg.do_phy_mst)

    def _turb_apply(self, ltraj, prog):
        """The frozen-K diffusion, then the shared D-grid edges made
        single-owner again through the padding."""
        n = self.n
        fs = {k: prog[k] for k in PHYS_FIELDS[2:]}
        fs["u"] = prog["u"][..., :n, :]
        fs["v"] = prog["v"][..., :, :n]
        out = self._turb.apply(ltraj, fs)
        u = torch.cat([out["u"], prog["u"][..., n:, :]], -2)
        v = torch.cat([out["v"], prog["v"][..., :, n:]], -1)
        st, _ = self.pad(dict(prog, u=u, v=v))
        n1 = slice(NG, NG + n + 1)
        nn = slice(NG, NG + n)
        return dict(prog, u=st["u"][:, :, n1, nn], v=st["v"][:, :, nn, n1],
                    **{k: out[k] for k in PHYS_FIELDS[2:]})

    def _moist_lin(self, ltraj, p):
        """The moist step as a function of the perturbation `p`, whose
        derivative at p = 0 is the moist tangent linear."""
        m = self._moist
        x0 = m._x0(ltraj)
        dx = m._marshal_in(ltraj, p)
        y = m._moist_step(ltraj, {k: x0[k] + dx[k] for k in x0})
        return m._writeback(ltraj, p, y)

    # -- the tangent linear and the adjoint -----------------------------------

    def tl(self, lin: Linearization, dx):
        """M dx: each stage's jvp at its kept input, then the physics'."""
        p = self.cast({k: dx[k] for k in self.prog_3d})
        for g, s in lin.segments:
            p = torch.func.jvp(g, (s,), (p,))[1]
        if lin.moist is not None:
            from fvref.physics.moist import _jvp
            zeros = {k: torch.zeros_like(v) for k, v in p.items()}
            p = _jvp(lambda z, c: self._moist_lin(c, z), (zeros,), (p,),
                     lin.moist)[1]
        if lin.turb is not None:
            p = self._turb_apply(lin.turb, p)
        return p

    def ad(self, lin: Linearization, dy):
        """M^T dy: the physics' vjps, then each segment's, last first."""
        pb = self.cast({k: dy[k] for k in self.prog_3d})
        if lin.turb is not None:
            pb = vjp(lambda f: self._turb_apply(lin.turb, f), (pb,), pb)[0]
        if lin.moist is not None:
            zeros = {k: torch.zeros_like(v) for k, v in pb.items()}
            pb = vjp(lambda z: self._moist_lin(lin.moist, z), (zeros,),
                     pb)[0]
        ct = pb
        for f, s in reversed(lin.segments):
            ct = vjp(f, (s,), ct)[0]
        return ct
