"""The port's operators against the NumPy transcriptions of the Fortran.

tests/test_reference_oracle.py holds straight transcriptions of the
reference's loops; its tests hold the JAX package to them.  These hold the
port's own operators to the same oracles, on the same inputs from the same
seeds and at the same tolerances, with no JAX program involved:

* `ops/ppm.xppm` at iord 8 (the trajectory scheme) against
  `oracle_xppm8_row` (tp_core_nlm.F90:474-577), rtol 2e-13, atol 1e-13;
* `ops/fv_mapz.map1_ppm` at kord 17, iv 1 (the perturbation remap)
  against `oracle_map1_kord17_column` (fv_mapz_nlm.F90:1332-1424 with
  cs_profile's linear branch), rtol 5e-12, atol 1e-12.
"""

import numpy as np
import pytest
import torch

from fv3jedi_lm_tpu_torch import NG
from fv3jedi_lm_tpu_torch.ops.fv_mapz import map1_ppm
from fv3jedi_lm_tpu_torch.ops.ppm import xppm
from test_reference_oracle import oracle_map1_kord17_column, oracle_xppm8_row

torch.set_num_threads(1)


def _xppm_case():
    """test_xppm_iord8_matches_oracle's inputs: 6 rows at npx 13, seed 0."""
    npx = 13
    n = npx - 1
    ic = n + 2 * NG
    rng = np.random.default_rng(0)
    rows = 6
    q = rng.standard_normal((rows, ic)) * 3.0 + 10.0
    dxa = 1.0 + 0.2 * rng.random((rows, ic))
    c = rng.uniform(-0.9, 0.9, (rows, n + 1))
    return npx, q, c, dxa


@pytest.mark.parametrize("row", range(6))
def test_xppm_iord8_matches_oracle(row):
    npx, q, c, dxa = _xppm_case()
    got = xppm(torch.as_tensor(q), torch.as_tensor(c), 8,
               torch.as_tensor(dxa)).numpy()
    want = oracle_xppm8_row(q[row], c[row], dxa[row], npx)
    np.testing.assert_allclose(got[row], want, rtol=2e-13, atol=1e-13,
                               err_msg=f"row {row}")


def _map1_case():
    """test_map1_ppm_kord17_matches_oracle's inputs: km 14, 10 columns,
    seed 2."""
    km = 14
    ncol = 10
    rng = np.random.default_rng(2)
    pe1 = np.sort(rng.random((km + 1, ncol)), axis=0) * 9.0e4 + 100.0
    pe1[0] = 100.0
    pe1[-1] = 1.0e5
    frac = np.sort(rng.random((km - 1, ncol)), axis=0)
    pe2 = np.concatenate([pe1[:1], 100.0 + frac * (1.0e5 - 100.0),
                          pe1[-1:]], axis=0)
    a1 = rng.standard_normal((km, ncol)) * 5.0 + 20.0
    return km, pe1, pe2, a1


@pytest.mark.parametrize("col", range(10))
def test_map1_ppm_kord17_matches_oracle(col):
    km, pe1, pe2, a1 = _map1_case()
    got = map1_ppm(torch.as_tensor(pe1), torch.as_tensor(a1), None,
                   torch.as_tensor(pe2), 1, 17).numpy()
    want = oracle_map1_kord17_column(km, km, pe1[:, col], pe2[:, col],
                                     a1[:, col])
    np.testing.assert_allclose(got[:, col], want, rtol=5e-12, atol=1e-12,
                               err_msg=f"col {col}")
