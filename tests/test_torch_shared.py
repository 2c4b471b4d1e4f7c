"""tests/torch_shared.py: a result computed once and shared between
processes (`shared_result`), and kept across test sessions (`shared`)."""

import json
import os
import subprocess
import sys

from torch_shared import REPO, TESTS, digest

_ASK = r"""
import json, os, pathlib, sys, time
sys.path.insert(0, sys.argv[1])
from torch_shared import shared_result
root, me = pathlib.Path(sys.argv[2]), sys.argv[3]
(root / "locks").mkdir(exist_ok=True)
(root / f"started-{me}").touch()

def compute():
    with open(root / "computed", "a") as f:
        f.write(me)
    t0 = time.time()        # hold the lock until both processes asked
    while len(list(root.glob("started-*"))) < 2 and time.time() - t0 < 60:
        time.sleep(0.05)
    time.sleep(0.5)
    if me == "dies":
        os._exit(3)
    return {"by": me, "values": [0.1 * i for i in range(5)]}

print(json.dumps(shared_result(root, "module.fixture[1]", "d", compute)))
"""


def _ask(tmp_path, names):
    """Start one process per name, all asking for one key at once."""
    procs = [subprocess.Popen([sys.executable, "-c", _ASK, str(TESTS),
                               str(tmp_path), me], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for me in names]
    return procs, [p.communicate(timeout=120) for p in procs]


def test_two_processes_compute_once(tmp_path):
    """Two processes ask for one key at once: compute() runs in one of
    them, and both get the same result."""
    procs, outs = _ask(tmp_path, ("a", "b"))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    computed = (tmp_path / "computed").read_text()
    assert len(computed) == 1, computed
    got = [json.loads(out) for out, _ in outs]
    assert got[0] == got[1] and got[0]["by"] == computed


def test_a_process_that_dies_leaves_no_result(tmp_path):
    """A process that dies while it computes releases the lock and leaves
    no result: the process that waited computes it."""
    (tmp_path / "started-b").touch()       # so "dies" holds the lock first
    procs, outs = _ask(tmp_path, ("dies",))
    assert procs[0].returncode == 3, outs[0][1][-2000:]
    assert not list(tmp_path.glob("*.pkl"))
    procs, outs = _ask(tmp_path, ("b",))
    assert procs[0].returncode == 0, outs[0][1][-2000:]
    assert (tmp_path / "computed").read_text() == "diesb"
    assert json.loads(outs[0][0])["by"] == "b"


# ---- the store kept across sessions --------------------------------------

_MODULE = '''
import pathlib

import pytest

import torch_shared

torch_shared.STORE = pathlib.Path({store!r})


def compute(scale):
    with open({log!r}, "a") as f:
        f.write("x")
    return {{"values": [scale * i for i in range(3)]}}


@pytest.fixture(scope="module")
def ref(request):
    return torch_shared.shared(request, compute, 0.5)


def test_ref(ref):
    assert ref == {{"values": [0.0, 0.5, 1.0]}}
'''


def _kept_module(tmp_path):
    """A test module whose fixture keeps a result in tmp_path/store; its
    compute() appends to tmp_path/computed."""
    path = tmp_path / "test_kept.py"
    path.write_text(_MODULE.format(store=str(tmp_path / "store"),
                                   log=str(tmp_path / "computed")))
    return path


def _session(tmp_path, path, name):
    """One pytest session of the module at `path`, with a temporary
    directory of its own; returns the store's entries after it."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(TESTS), str(REPO), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", f"--basetemp={tmp_path / name}", str(path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return sorted(p.name for p in (tmp_path / "store").glob("*.pkl"))


def test_a_later_session_reads_the_entry(tmp_path):
    """An entry written by one session is read by the next, which has
    another temporary directory, and compute() does not run again."""
    path = _kept_module(tmp_path)
    first = _session(tmp_path, path, "one")
    assert _session(tmp_path, path, "two") == first
    assert len(first) == 1 and first[0].startswith("test_kept.ref@")
    assert (tmp_path / "computed").read_text() == "x"


def test_a_changed_input_computes_again(tmp_path):
    """A change to a file the digest covers computes the result again and
    replaces the entry; so would other inputs from the port."""
    path = _kept_module(tmp_path)
    first = _session(tmp_path, path, "one")
    path.write_text(path.read_text() + "# changed\n")
    second = _session(tmp_path, path, "two")
    assert len(second) == 1 and second != first
    assert (tmp_path / "computed").read_text() == "xx"
    assert digest(path, (0.5,)) != digest(path, (0.25,))


def test_another_machine_purges_the_store(tmp_path):
    """An entry of a store stamped by another machine is removed, and the
    result computed again."""
    path = _kept_module(tmp_path)
    first = _session(tmp_path, path, "one")
    (tmp_path / "store" / "MACHINE_TAG").write_text("another machine")
    assert _session(tmp_path, path, "two") == first
    assert (tmp_path / "computed").read_text() == "xx"
    assert (tmp_path / "store" / "MACHINE_TAG").read_text() != (
        "another machine")
