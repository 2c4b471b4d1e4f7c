"""A frozen copy of the plain-PyTorch modules of the port
(fv3jedi_lm_tpu_torch at commit 0fe27a5): the dynamics, the operators, the
halos, the grid and the GEOS physics, kept here as the benchmark's plain
reference.  Later changes to the port do not reach it.

Left out: the facade (`lm.py`), the staged sweeps with their checkpoints
and tapes (`core/staged.py`), the SIM1 kernel (`ops/cuda_sim1.py`,
`csrc/`), the decomposition (`parallel/faces.py`, `ppermute.py`) and
`debug.py`.  Changed: `core/nh_core._sim1` runs the plain SIM1 in every
mode, and the physics take `vjp` from `autodiff.py`.  Every other file is
the port's, byte for byte.  `benchmark/reference.py` drives it.
"""

# Imported with the package, as the port does, so that the first jvp does
# not leave a reference cycle among the frames live at that moment.
import torch._dynamo  # noqa: F401

NG = 3  # halo width

__version__ = "0.1.0"
