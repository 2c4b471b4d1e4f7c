"""fv3jedi_lm_tpu_torch: the PyTorch/CUDA port of fv3jedi_lm_tpu.

The subpackage layout and module names mirror ``fv3jedi_lm_tpu`` so that
each module's counterpart is found by its path.  The port keeps its own
copies of the JAX package's NumPy-only modules (``config``, ``constants``,
``grid.gnomonic``, ``grid.sphere``, ``grid.topology``, ``grid.metrics``,
``grid.eta``, and ``NG`` here) and imports neither JAX nor the JAX package.

Layout conventions are those of the JAX package: 3-D fields are tensors of
shape ``(npz, 6, jdim, idim)``, 2-D fields ``(6, jdim, idim)``, every face
carries an ``NG=3`` halo.  Functions are plain functions on tensors; the
tensors' device decides where they run, and ``LinearModel`` puts its grid
and states on the GPU unless it is given ``device="cpu"``.

The port runs what the JAX package runs on one device: ``step_nl`` and
``run_nl``, the staged tangent-linear and adjoint sweeps with their
checkpoints and bit-packed branch tapes, the GEOS physics and the 4D-Var
window.  SIM1, the nonhydrostatic vertical solver of the trajectory
substeps, runs as a hand-written CUDA kernel on the GPU
(``ops/cuda_sim1.py``, ``csrc/sim1.cu``).
"""

# Imported with the package, not by the first jvp that needs it: its
# import leaves a reference cycle among the Python frames live at that
# moment (torch.fx.wrap keeps `inspect.currentframe()`), which would keep
# the model that made that jvp alive until a cyclic collection.
import torch._dynamo  # noqa: F401

NG = 3  # halo width, reference: fv_mp_nlm_mod.F90 `ng` (single value used by the LM)

__version__ = "0.1.0"
