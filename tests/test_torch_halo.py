"""Halo exchange of the PyTorch port against the JAX package, bitwise.

Every halo function of fv3jedi_lm_tpu_torch/parallel/halo.py gets the same
random float64 fields (numpy, from a seed) as its fv3jedi_lm_tpu
counterpart at c12 (npx=13); the exchanges only copy and flip signs, so
the results must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3jedi_lm_tpu.grid.topology import get_topology
from fv3jedi_lm_tpu.parallel import halo as jhalo
from fv3jedi_lm_tpu_torch.grid.topology import get_topology as port_topology
from fv3jedi_lm_tpu_torch.parallel import halo as thalo

torch.set_num_threads(1)

NPX = 13
NPZ = 3


@pytest.fixture(scope="module")
def topo():
    return get_topology(NPX)


@pytest.fixture(scope="module")
def ttopo():
    """The port's own topology (its copy of grid/topology.py)."""
    return port_topology(NPX)


def _shape(topo, kind):
    """(J, I) of a field, read off the topology map it is exchanged by."""
    maps = {
        "center": lambda: topo.halo_map_center(),
        "corner": lambda: topo.halo_map_corner(),
        "dgrid": lambda: topo.halo_map_dgrid(),
        "cgrid": lambda: topo.halo_map_cgrid(),
        "edgefix": lambda: topo.edge_fix_maps_dgrid(),
    }
    m = maps[kind]()
    if isinstance(m, dict):
        first = m["x"] if "x" in m else m["u"]
        second = m["y"] if "y" in m else m["v"]
        return first["idx_same"].shape[-2:], second["idx_same"].shape[-2:]
    return m.shape[-2:]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal((NPZ, 6) + tuple(shape))


# (halo function name, field kind, extra arguments)
def _cases():
    c = []
    for name in ("fill_halo_center", "fill_halo_corner"):
        kind = "center" if name.endswith("center") else "corner"
        c.append((name, kind, ()))
    for name, kind in (("fill_halo_dgrid", "dgrid"),
                       ("fill_halo_cgrid", "cgrid"),
                       ("fill_halo_dgrid_scalar_pair", "dgrid"),
                       ("fill_halo_cgrid_scalar_pair", "cgrid"),
                       ("fix_shared_edges_dgrid", "edgefix")):
        c.append((name, kind, ()))
    for d in (1, 2):
        c.append(("copy_corners", "center", (d,)))
        c.append(("fill_corners_scalar", "center", ("agrid", d)))
        c.append(("fill_corners_scalar", "corner", ("bgrid", d)))
    for grid in ("dgrid", "cgrid", "agrid"):
        for vector in (True, False):
            c.append(("fill_corners_vector", grid, (grid, vector)))
    return c


CASES = _cases()


@pytest.mark.parametrize(
    "name,kind,extra", CASES,
    ids=[f"{n}-{'-'.join(map(str, e))}" if e else n for n, _, e in CASES])
def test_halo_bitwise(topo, ttopo, name, kind, extra):
    jf = getattr(jhalo, name)
    tf = getattr(thalo, name)
    if name == "fill_corners_vector":
        grid, vector = extra
        mx, my = {"dgrid": topo.fill_corners_dgrid_maps,
                  "cgrid": topo.fill_corners_cgrid_maps,
                  "agrid": topo.fill_corners_agrid_maps}[grid](vector)
        shapes = (mx["idx_same"].shape, my["idx_same"].shape)
    elif kind in ("dgrid", "cgrid", "edgefix"):
        shapes = _shape(topo, kind)
    else:
        shapes = (_shape(topo, kind),)
    fields = [_rand(s, seed) for seed, s in enumerate(shapes)]
    want = jf(*[jnp.asarray(f) for f in fields], topo, *extra)
    got = tf(*[torch.as_tensor(f) for f in fields], ttopo, *extra)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w), (name, extra)
    # the exchange changed something (the maps are not the identity)
    assert any(not np.array_equal(np.asarray(w), f)
               for w, f in zip(want, fields))
