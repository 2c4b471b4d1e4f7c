"""Simplified GEOS physics linearizations (counterpart of
fv3jedi_lm_tpu/physics/): the boundary-layer turbulence (turbulence.py,
bldriver.py) and the RAS convection + PDF cloud moist physics (moist.py,
convection.py, cloud.py, qsat.py)."""
