"""Physical constants for the TPU-native FV3 linear model.

The port's own copy of fv3jedi_lm_tpu/constants.py, identical to it
but for this paragraph: its imports resolve within
fv3jedi_lm_tpu_torch, so the port never imports the JAX package.

Two constant conventions coexist, mirroring the reference framework:

* the FV3/JEDI set (reference: src/utils/fv3jedi_lm_const_mod.F90:11-58)
* the GEOS/MAPL set used by the physics (reference: src/utils/MAPL_Constants.F90:6-63)

They differ in small ways (e.g. MAPL_KAPPA is derived identically here, but the
moist-physics code paths historically expect the MAPL names).  All values are plain
Python floats; array code casts to the configured dtype.
"""

import math

# --- FV3/JEDI convention (fv3jedi_lm_const_mod.F90) ---
PI = math.pi
RAD2DEG = 57.29577954572
DEG2RAD = 0.01745329251
GRAV = 9.80665
RADIUS = 6371.0e3
OMEGA = 2.0 * PI / 86164.0
STFBOL = 5.6734e-8
AIRMW = 28.965
H2OMW = 18.015
O3MW = 47.9982
RUNIV = 8314.47
ALHL = 2.4665e6
ALHF = 3.3370e5
ALHS = ALHL + ALHF
RDRY = RUNIV / AIRMW
CPDRY = 3.5 * RDRY
CVDRY = CPDRY - RDRY
RVAP = RUNIV / H2OMW
CPVAP = 4.0 * RVAP
CVVAP = CPVAP - RVAP
KAPPA = RDRY / CPDRY
EPSILON = H2OMW / AIRMW
RGAS = RDRY
CP = RGAS / KAPPA
CV_AIR = CP - RGAS
ZVIR = RVAP / RGAS - 1.0
VIREPS = 1.0 / EPSILON - 1.0
P00 = 100000.0
TICE = 273.16
KARMAN = 0.40
USMIN = 1.00
CONSTOZ = 604229.0

# --- GEOS/MAPL convention (MAPL_Constants.F90) ---
MAPL_GRAV = 9.80665
MAPL_RADIUS = 6371.0e3
MAPL_OMEGA = 2.0 * PI / 86164.0
MAPL_AIRMW = 28.965
MAPL_H2OMW = 18.015
MAPL_RUNIV = 8314.47
MAPL_ALHL = 2.4665e6
MAPL_ALHF = 3.3370e5
MAPL_ALHS = MAPL_ALHL + MAPL_ALHF
MAPL_RGAS = MAPL_RUNIV / MAPL_AIRMW
MAPL_CP = MAPL_RGAS / (2.0 / 7.0)
MAPL_KAPPA = MAPL_RGAS / MAPL_CP
MAPL_RVAP = MAPL_RUNIV / MAPL_H2OMW
MAPL_EPSILON = MAPL_H2OMW / MAPL_AIRMW
MAPL_VIREPS = 1.0 / MAPL_EPSILON - 1.0
MAPL_P00 = 100000.0
MAPL_TICE = 273.16
MAPL_PI = PI
