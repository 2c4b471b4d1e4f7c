"""The port stands alone: it imports neither JAX nor the JAX package, its
own copies of the JAX package's NumPy-only modules compute what the
originals compute bit for bit, and its entry point runs on the card unless
the caller asks for the CPU.

No JAX function is compiled here: the copies are NumPy, so each pair is
compared directly (grids at c12 and c24, ak/bk, constants, configs, and
the physics' tables: the saturation table ESTBLX and its polynomials,
RASPARAMS, CLOUDPARAMS, the turbulence parameters and the ACRITN tables),
and the exchange plan the port's parallel/ppermute.py copies.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from fv3jedi_lm_tpu import config as jax_config
from fv3jedi_lm_tpu import constants as jax_constants
from fv3jedi_lm_tpu.grid import eta as jax_eta
from fv3jedi_lm_tpu.grid import metrics as jax_metrics
from fv3jedi_lm_tpu.parallel import ppermute as jax_ppermute
from fv3jedi_lm_tpu.physics import bldriver as jax_bldriver
from fv3jedi_lm_tpu.physics import cloud as jax_cloud
from fv3jedi_lm_tpu.physics import convection as jax_convection
from fv3jedi_lm_tpu.physics import qsat as jax_qsat
from fv3jedi_lm_tpu_torch import config as port_config
from fv3jedi_lm_tpu_torch import constants as port_constants
from fv3jedi_lm_tpu_torch.grid import eta as port_eta
from fv3jedi_lm_tpu_torch.grid import metrics as port_metrics
from fv3jedi_lm_tpu_torch.parallel import ppermute as port_ppermute
from fv3jedi_lm_tpu_torch.physics import bldriver as port_bldriver
from fv3jedi_lm_tpu_torch.physics import cloud as port_cloud
from fv3jedi_lm_tpu_torch.physics import convection as port_convection
from fv3jedi_lm_tpu_torch.physics import qsat as port_qsat
from test_torch_d_sw import D_SW_KW
from test_torch_hydro import D_SW_KW as HYDRO_D_SW_KW
from test_torch_step_nl import NH_KW as STEP_NL_KW

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fv3jedi_lm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    fv3jedi_lm_tpu_torch.__path__, prefix="fv3jedi_lm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke            # as a module: main() does not run
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "fv3jedi_lm_tpu")
             or m.startswith(("jax.", "jaxlib.", "fv3jedi_lm_tpu.")))
print("MODULES", len(names))
print("FOREIGN", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke, imported in a fresh
    process, leave neither jax nor any module of the JAX package in
    sys.modules."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in r.stdout.splitlines())
    assert int(lines["MODULES"]) >= 25, r.stdout
    assert lines["FOREIGN"] == "[]", r.stdout


def _bits_equal(a, b, path="."):
    """a and b hold the same values bit for bit: dicts and sequences
    element by element, arrays by dtype, shape and bytes."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _bits_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _bits_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), path
    else:
        assert a == b, path


CONSTANTS = sorted(n for n in vars(jax_constants) if n.isupper())


def test_constants_same_names():
    assert CONSTANTS == sorted(n for n in vars(port_constants)
                               if n.isupper())


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches(name):
    _bits_equal(getattr(port_constants, name), getattr(jax_constants, name))


@pytest.mark.parametrize("npz", [10, 24, 72])
def test_default_ak_bk_matches(npz):
    _bits_equal(port_eta.default_ak_bk(npz), jax_eta.default_ak_bk(npz))


GRID_FIELDS = [f.name for f in dataclasses.fields(port_metrics.GridMetrics)
               if f.name != "topo"]


@pytest.fixture(scope="module")
def grids():
    return {npx: (port_metrics.build_grid(npx), jax_metrics.build_grid(npx))
            for npx in (13, 25)}


def test_grid_fields_same_names():
    assert GRID_FIELDS == [f.name for f in dataclasses.fields(
        jax_metrics.GridMetrics) if f.name != "topo"]


@pytest.mark.parametrize("field", GRID_FIELDS)
@pytest.mark.parametrize("npx", [13, 25])
def test_grid_field_matches(grids, npx, field):
    port, ref = grids[npx]
    _bits_equal(getattr(port, field), getattr(ref, field), field)


#: every map of CubeTopology the halo exchange and the corner fills read
TOPOLOGY_MAPS = (
    [("halo_map_center", ()), ("halo_map_corner", ()),
     ("halo_map_dgrid", ()), ("halo_map_cgrid", ()),
     ("halo_map_agrid_vector", ()), ("edge_fix_maps_dgrid", ())]
    + [(m, (d,)) for m in ("copy_corners_map", "fill_corners_bgrid_map",
                           "fill_corners_agrid_scalar_map") for d in (1, 2)]
    + [(m, (v,)) for m in ("fill_corners_dgrid_maps",
                           "fill_corners_cgrid_maps",
                           "fill_corners_agrid_maps") for v in (True, False)]
    + [("corner_region_mask", off) for off in ((0.0, 0.0), (0.5, 0.5),
                                               (0.5, 0.0), (0.0, 0.5))])


@pytest.mark.parametrize(
    "method,args", TOPOLOGY_MAPS,
    ids=[f"{m}{a}" for m, a in TOPOLOGY_MAPS])
@pytest.mark.parametrize("npx", [13, 25])
def test_topology_map_matches(grids, npx, method, args):
    port, ref = grids[npx]
    _bits_equal(getattr(port.topo, method)(*args),
                getattr(ref.topo, method)(*args), method)


@pytest.mark.parametrize("npx", [13, 25])
def test_topology_connectivity_matches(grids, npx):
    port, ref = grids[npx]
    for attr in ("npx", "ng", "n", "neighbor", "corners_int"):
        _bits_equal(getattr(port.topo, attr), getattr(ref.topo, attr), attr)


#: the face decomposition's modules, which no test of the JAX package's
#: multi-device path may need
PARALLEL_MODULES = ("fv3jedi_lm_tpu_torch.parallel.ppermute",
                    "fv3jedi_lm_tpu_torch.parallel.exchange",
                    "fv3jedi_lm_tpu_torch.parallel.faces")


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_module_imports_no_jax(module):
    """Each module of the face decomposition, imported alone in a fresh
    process, leaves neither jax nor the JAX package in sys.modules."""
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fv3jedi_lm_tpu')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[]", r.stdout


@pytest.mark.parametrize("npx", [13, 25])
def test_center_plan_matches(grids, npx):
    """parallel/ppermute._center_plan, the port's copy, builds the JAX
    package's exchange plan bit for bit."""
    port, ref = grids[npx]
    _bits_equal(port_ppermute._center_plan(port.topo),
                jax_ppermute._center_plan(ref.topo))


@pytest.mark.parametrize("name", ["_esat_liquid", "_esat_ice"])
def test_qsat_polynomials_match(name):
    t = np.linspace(140.0, 340.0, 20001)
    _bits_equal(getattr(port_qsat, name)(t), getattr(jax_qsat, name)(t))


def test_estblx_matches():
    """The saturation table and its constants, bit for bit."""
    _bits_equal(port_qsat.ESTBLX, jax_qsat.ESTBLX)
    _bits_equal(port_qsat.build_estblx(), jax_qsat.build_estblx())
    for k in ("DEGSUBS", "TMINTBL", "TMAXTBL", "TABLESIZE", "ZEROC", "ESFAC",
              "MAX_MIXING_RATIO"):
        _bits_equal(getattr(port_qsat, k), getattr(jax_qsat, k), k)


@pytest.mark.parametrize("npx", [9, 49, 97, 193, 401])
def test_physics_parameter_tables_match(npx):
    """default_rasparams, cloud_params and default_turb_params (on the
    default L72 and the moist tests' L12 coordinates), and the ACRITN
    tables, at each resolution class of their imsize switches."""
    _bits_equal(port_convection.default_rasparams(npx),
                jax_convection.default_rasparams(npx))
    _bits_equal(port_cloud.cloud_params(npx - 1),
                jax_cloud.cloud_params(npx - 1))
    for ak, bk in (port_eta.default_ak_bk(72),
                   (chip_smoke.PHYS_AK, chip_smoke.PHYS_BK)):
        pref = np.asarray(ak) + np.asarray(bk) * 1.0e5
        _bits_equal(port_bldriver.default_turb_params(pref),
                    jax_bldriver.default_turb_params(pref))
    _bits_equal(port_convection.ACRIT_PH, jax_convection.ACRIT_PH)
    _bits_equal(port_convection.ACRIT_A, jax_convection.ACRIT_A)


#: the configurations the port's tests and chip_smoke.py build models from
CONFIGS = {"step_nl": STEP_NL_KW, "d_sw": D_SW_KW,
           "hydro_d_sw": HYDRO_D_SW_KW,
           "chip_smoke_phys_small": chip_smoke.PHYS_SMALL_KW,
           "chip_smoke_small": chip_smoke.SMALL_KW,
           "chip_smoke_c96L72": chip_smoke.FULL_KW,
           "chip_smoke_tlad_c96L72": chip_smoke.TLAD_FULL_KW,
           **{f"chip_smoke_tlad_{k}": v
              for k, v in chip_smoke.TLAD_SMALL.items()}}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dynconfig_resolve_matches(name):
    kw = CONFIGS[name]
    port = port_config.DynConfig(**kw).resolve()
    ref = jax_config.DynConfig(**kw).resolve()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    lm = port_config.LMConfig(dyn=port, dt=450.0)
    jlm = jax_config.LMConfig(dyn=ref, dt=450.0)
    assert dataclasses.asdict(lm) == dataclasses.asdict(jlm)


def test_create_defaults_to_the_card(monkeypatch):
    """Without a device argument the model goes to the GPU; on a host
    without CUDA that raises before anything is built on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import fv3jedi_lm_tpu_torch.lm as tlm

    def no_grid(*a, **k):
        raise AssertionError("a grid was built on the CPU")

    monkeypatch.setattr(tlm, "build_grid", no_grid)
    cfg = port_config.LMConfig(dyn=port_config.DynConfig(**STEP_NL_KW),
                               dt=450.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tlm.LinearModel.create(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.LinearModel(cfg)


@pytest.mark.parametrize("n", range(1, 9))
def test_layout_matches_mesh(n):
    """The port's own layout of n ranks is the JAX package's ('face', 'y',
    'x') mesh shape (`__graft_entry__._mesh_for`) on conftest's virtual
    CPU devices."""
    import jax
    from __graft_entry__ import _mesh_for
    from fv3jedi_lm_tpu_torch.parallel.faces import layout

    if jax.device_count() < n:
        pytest.skip(f"needs {n} JAX devices")
    mesh, y, x = _mesh_for(n)
    assert tuple(mesh.devices.shape) == layout(n)
    assert layout(n)[1:] == (y, x)
