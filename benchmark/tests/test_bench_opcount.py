"""The operation counter behind `pair_mfu`."""

import torch

import opcount


def test_counts_arithmetic_not_copies():
    x = torch.ones(10)
    with opcount.OpCounter() as c:
        y = x * 2.0 + 1.0           # 10 + 10
        y.sum()                     # 10 (its input)
        torch.where(y > 0, y, -y)   # 10 (the comparison) + 10 (the neg)
        y[2:5].clone()              # nothing: a view and a copy
        torch.zeros(4)              # nothing: creation
    assert c.by_name == {"mul": 10, "add": 10, "sum": 10, "gt": 10,
                         "neg": 10}
    assert c.total == 50


def test_counts_tangent_operations_of_jvp():
    x = torch.ones(10)
    with opcount.OpCounter() as c:
        torch.func.jvp(lambda a: a * a, (x,), (x,))
    # the primal product and the tangent's two products and one sum
    assert c.by_name == {"mul": 30, "add": 10}


def test_counts_matrix_products():
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    with opcount.OpCounter() as c:
        a @ b
    assert c.total == 2 * 3 * 5 * 4
