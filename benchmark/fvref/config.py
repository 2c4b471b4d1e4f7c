"""Model configuration.

The port's own copy of fv3jedi_lm_tpu/config.py, identical to it
but for this paragraph: its imports resolve within
fv3jedi_lm_tpu_torch, so the port never imports the JAX package.

One typed, hashable config replaces the reference's three config surfaces
(programmatic conf: src/utils/fv3jedi_lm_utils_mod.F90:14-32; `fv_core_nml`:
src/dynamics/atmos_cubed_sphere/model/fv_control_nlm.F90:556-577; and
`fv_core_pert_nml`: model_tlmadm/fv_control_tlmadm.F90:187-193).

Defaults follow the reference's flag defaults (model/fv_arrays_nlm.F90:236-506
for trajectory options, model_tlmadm/fv_arrays_tlmadm.F90:37-92 for the
perturbation/linearization options) with the LM's hardwired overrides applied
(src/dynamics/fv3jedi_lm_dynamics_mod.F90:147-152: no sat_adj, no fill, no
vortex breeding, adiabatic=false, reproduce_sum=false).

The config is a frozen dataclass so it can be a jit static argument.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DynConfig:
    """Dynamical-core configuration (trajectory + perturbation numerics)."""

    # --- resolution / decomposition ---
    npx: int = 49            # number of grid corners per face side (c48 -> 49)
    npy: int = 49
    npz: int = 72
    ntiles: int = 6

    # --- time splitting (fv_arrays_nlm.F90:330-339) ---
    k_split: int = 1         # vertical-remap outer splits per dt
    n_split: int = 6         # acoustic sub-steps per k_split
    q_split: int = 0         # tracer sub-cycles (0 => computed from CFL; LM uses fixed)
    m_split: int = 0

    # --- trajectory advection operators (fv_arrays_nlm.F90:237-246) ---
    hord_mt: int = 9
    hord_vt: int = 9
    hord_tm: int = 9
    hord_dp: int = 9
    hord_tr: int = 8

    # --- vertical remap operators ---
    kord_mt: int = 8
    kord_wz: int = 8
    kord_tm: int = 8
    kord_tr: int = 8

    # --- damping (fv_arrays_nlm.F90:247-262) ---
    nord: int = 1            # 0: del-2, 1: del-4, 2: del-6 divergence damping
    dddmp: float = 0.2       # Smagorinsky-like del-2 divergence damping coeff
    d2_bg: float = 0.0
    d4_bg: float = 0.16
    vtdm4: float = 0.0       # del-4 vorticity damping
    do_vort_damp: bool = False
    d2_bg_k1: float = 4.0
    d2_bg_k2: float = 2.0
    d_ext: float = 0.0       # external-mode damping (LM default off)
    d_con: float = 0.0       # dissipative heating fraction
    ke_bg: float = 0.0
    n_sponge: int = 0
    dnats: int = 0

    # --- pressure-gradient / misc numerics ---
    beta: float = 0.0        # off-centering of the PG force (0 => forward-in-time)
    a2b_ord: int = 4
    c2l_ord: int = 4
    inline_q: bool = False
    z_tracer: bool = False
    fill_dp: bool = False
    adiabatic: bool = False

    # --- Rayleigh damping (fv_arrays_nlm.F90:286-288) ---
    tau: float = 0.0         # days; 0 => off
    rf_cutoff: float = 30.0e2
    grid_type: int = 0       # <4: cube (Rayleigh_Super); >=4: doubly periodic (Rayleigh_Friction)
    rayleigh_fast: bool = False  # HIWPP inline per-substep drag (dyn_core_nlm.F90:905-907,2219)
    p_fac: float = 0.05      # NH solver pressure floor factor (fv_arrays_nlm.F90)
    kord_wz: int = 8         # vertical-wind remap order (fv_arrays_nlm.F90:266)
    compute_omega: bool = False  # produce the omga diagnostic in step_nl
    nf_omega: int = 1        # del2_cubed filter passes on omga (fv_arrays_nlm.F90:399)

    # --- vertical coordinate / physics interface ---
    hydrostatic: bool = True
    ptop: float = 1.0        # overwritten by ak[0] when ak/bk supplied
    p_ref: float = 1.0e5
    ncnst: int = 4           # sphum, liq_wat, ice_wat, o3 (5 with moist physics, fv3jedi_lm_dynamics_mod.F90:159-167)
    nwat: int = 0
    consv_te: float = 0.0
    do_sat_adj: bool = False
    fv_sg_adj: int = -1
    nf_omega: int = 1
    convert_ke: bool = False
    delt_max: float = 1.0    # dissipative-heating rate limiter (fv_arrays_nlm.F90:409)
    nord_tr: int = 0         # tracer damping order (fv_arrays_nlm.F90:288)
    trdm2: float = 0.0       # del-2 tracer damping coeff (fv_arrays_nlm.F90:295)

    # ------------------------------------------------------------------
    # Perturbation (linearization) options, reference fv_arrays_tlmadm.F90:37-92.
    # hord 1: 1st-order upwind; 2: unlimited PPM-ish linear; 333: linear 3rd;
    # -5 / 6: other linear variants. |kord| > 16 => fully linear vertical remap.
    # ------------------------------------------------------------------
    split_hord: bool = True            # use separate pert advection options
    hord_mt_pert: int = 2
    hord_vt_pert: int = 2
    hord_tm_pert: int = 2
    hord_dp_pert: int = 2
    hord_tr_pert: int = 2
    # sponge-layer overrides: levels k < n_sponge_pert use first-order advection
    n_sponge_pert: int = 9
    hord_ks_pert: int = 1              # pert advection in pert sponge layers
    hord_ks_traj: int = 1              # traj advection in pert sponge layers (if split)

    split_kord: bool = True
    kord_mt_pert: int = 17
    kord_wz_pert: int = 17
    kord_tm_pert: int = 17
    kord_tr_pert: int = 17

    split_damp: bool = True
    nord_pert: int = 1
    dddmp_pert: float = 0.2
    d2_bg_pert: float = 0.015
    d4_bg_pert: float = 0.150
    do_vort_damp_pert: bool = True
    vtdm4_pert: float = 0.0005
    d2_bg_k1_pert: float = 4.0       # sponge del-2 coeff, k=1 (fv_arrays_tlmadm.F90:84)
    d2_bg_k2_pert: float = 2.0       # k=2
    d2_bg_ks_pert: float = 2.0       # 3 <= k <= n_sponge_pert
    split_damp_tr: bool = True
    nord_tr_pert: int = 0
    trdm2_pert: float = 0.0

    # --- precision ---
    dtype: str = "float64"   # reference is REAL64 (-r8); use float32 for perf runs

    def resolve(self) -> "DynConfig":
        """Apply the split_* coupling: unless split, the TRAJECTORY adopts
        the perturbation coefficients (fv_control_tlmadm.F90:220-252)."""
        kw = {}
        if not self.split_damp:
            kw.update(nord=self.nord_pert, dddmp=self.dddmp_pert,
                      d2_bg=self.d2_bg_pert, d4_bg=self.d4_bg_pert,
                      do_vort_damp=self.do_vort_damp_pert,
                      vtdm4=self.vtdm4_pert,
                      d2_bg_k1=self.d2_bg_k1_pert,
                      d2_bg_k2=self.d2_bg_k2_pert)
        if not self.split_damp_tr:
            kw.update(nord_tr=self.nord_tr_pert, trdm2=self.trdm2_pert)
        if not self.split_hord:
            kw.update(hord_mt=self.hord_mt_pert, hord_vt=self.hord_vt_pert,
                      hord_tm=self.hord_tm_pert, hord_dp=self.hord_dp_pert,
                      hord_tr=self.hord_tr_pert)
        if not self.split_kord:
            kw.update(kord_mt=self.kord_mt_pert, kord_wz=self.kord_wz_pert,
                      kord_tm=self.kord_tm_pert, kord_tr=self.kord_tr_pert)
        return self.replace(**kw) if kw else self

    @property
    def nx(self) -> int:
        """Number of cells per face side."""
        return self.npx - 1

    @property
    def ny(self) -> int:
        return self.npy - 1

    def replace(self, **kw) -> "DynConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Top-level linear-model configuration.

    Mirrors `fv3jedi_lm_conf` (src/utils/fv3jedi_lm_utils_mod.F90:14-32).
    """

    dyn: DynConfig = dataclasses.field(default_factory=DynConfig)
    dt: float = 900.0
    nt: int = 1                      # window length in steps
    do_dyn: bool = True
    do_phy_trb: bool = False
    do_phy_mst: int = 0              # 0: off, 1: on, 2: stricter convection filter
    saveltraj: bool = False

    @property
    def do_phy(self) -> bool:
        return self.do_phy_trb or self.do_phy_mst > 0

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)
