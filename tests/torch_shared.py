"""The JAX references of the port's tests, computed once and kept across
runs.

The port's tests hold it to the JAX package, whose references (a trace,
a compile and a run of an NL, TL, AD, window or physics step) take most
of their time.  The JAX package does not change, so a reference is a
pure function of its sources, of the test module's inputs and of the
interpreter, jax, jaxlib and numpy on this machine.
`shared(request, compute, *args)` keeps each reference in `.port_refs/`
at the repository's root under a key that covers all of them (`digest`):
the first process to ask computes and pickles it, and every other one,
another xdist worker or a later run, reads it.  A change to any of them
computes it again; so does deleting the directory.
"""

import ast
import fcntl
import functools
import gc
import hashlib
import os
import pickle
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
#: where the references are kept (gitignored)
STORE = REPO / ".port_refs"


def shared_result(root, key, digest, compute):
    """compute() once for all the processes that ask for `key` at `digest`
    in the store `root` (made by `open_store`): the first to take the key's
    lock computes and pickles the result as `key@digest.pkl`, and removes
    the key's entries at any other digest; the others wait on the lock and
    unpickle it.  A process that dies while computing releases the lock and
    leaves no result, so the next one computes.  The result must pickle:
    numpy and plain Python, not a torch model or a JAX object."""
    path = root / f"{key}@{digest}.pkl"
    with open(root / "locks" / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            data = pickle.dumps(compute())
            path.with_suffix(".tmp").write_bytes(data)
            path.with_suffix(".tmp").replace(path)
            for old in root.glob("*.pkl"):
                if old != path and old.stem.rpartition("@")[0] == key:
                    old.unlink()
        return pickle.loads(path.read_bytes())


def open_store(root):
    """The store `root`, made if need be and emptied of the entries written
    on another machine (fv3jedi_lm_tpu/cachedir.py `ensure_compatible`
    stamps it with the CPU's features and removes its files when they
    change).  The locks live in `root/locks`, which that purge keeps."""
    from fv3jedi_lm_tpu.cachedir import ensure_compatible

    (root / "locks").mkdir(parents=True, exist_ok=True)
    with open(root / "locks" / "MACHINE_TAG.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ensure_compatible(str(root))
    return root


def local_imports(path):
    """The module file `path` and the files of tests/ and the repository's
    root that it imports, directly or through one another (the helpers a
    reference's inputs come from: chip_smoke.py, tests/test_lm.py, ...)."""
    seen, todo = set(), [Path(path)]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_bytes())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            todo += [d / f"{n}.py" for n in names for d in (TESTS, REPO)
                     if (d / f"{n}.py").is_file()]
    return seen


@functools.cache
def _common():
    """The part of every key that the whole process shares: the JAX
    package's sources, this file's, tests/conftest.py's, the interpreter's
    and the libraries' versions and the XLA settings."""
    import jax
    import jaxlib
    import numpy

    h = hashlib.sha256()
    for f in sorted((REPO / "fv3jedi_lm_tpu").rglob("*.py")) + [
            TESTS / "torch_shared.py", TESTS / "conftest.py"]:
        h.update(f"{f.relative_to(REPO)}\0".encode() + f.read_bytes())
    # a flag given twice (tests/conftest.py appends its own in every xdist
    # worker) is the same setting
    flags = sorted(set(os.environ.get("XLA_FLAGS", "").split()))
    h.update(repr((sys.version, jax.__version__, jaxlib.__version__,
                   numpy.__version__, flags,
                   jax.config.jax_enable_x64)).encode())
    return h


@functools.cache
def _module(path):
    h = _common().copy()
    for f in sorted(local_imports(path)):
        h.update(f"{f.name}\0".encode() + f.read_bytes())
    return h


def digest(module_file, args=()):
    """sha256 of what a reference of the test module `module_file` computed
    from `args` depends on: `_common`, the files of `local_imports` and the
    pickled `args`."""
    h = _module(str(module_file)).copy()
    h.update(pickle.dumps(args))
    return h.hexdigest()


def _released(compute):
    """compute, run between two releases of the JAX programs this process
    holds.  Each compiled program keeps memory regions mapped, and JAX's
    caches keep them after a module's fixtures are gone: a process that
    ran tests/test_lm.py's first three tests holds 41,151 maps, near the
    kernel's limit on a process's maps (vm.max_map_count, 65,530), and
    763 after this release and tests/test_torch_window.py's `window`.
    Without it, xdist workers have died of a segfault inside XLA while
    loading the next program from the compilation cache."""
    import jax

    def run():
        jax.clear_caches()
        gc.collect()
        try:
            return compute()
        finally:
            jax.clear_caches()
            gc.collect()
    return run


_opened = functools.cache(open_store)


def _key(request):
    """The module's name and the fixture's (with its parameter), or the
    test's with its parameters."""
    name = request.fixturename or request.node.name
    key = f"{request.module.__name__}.{name}"
    if hasattr(request, "param"):
        key += f"[{request.param}]"
    return key


def shared(request, compute, *args):
    """`compute(*args)` of the module fixture or test whose `request` is
    given, once for every process and every run on this machine
    (shared_result in `STORE`), keyed by `_key` and by `digest`, with the
    JAX programs this process holds released before and after
    (_released).  `compute` runs the JAX package on the module's fixed
    inputs and on `args`, the inputs the port made (numpy and plain
    Python), and returns numpy and plain Python.  Each caller gets its own
    unpickled copy."""
    return shared_result(_opened(STORE), _key(request),
                         digest(request.module.__file__, args),
                         _released(lambda: compute(*args)))


def per_session(request, compute):
    """`compute()` of the module fixture whose `request` is given, once per
    test session (shared_result in the session's temporary directory,
    which dies with it).  For the port's own results, which every run
    computes anew, where a fixture starts ranks that each xdist worker
    drawing one of the module's tests would otherwise start again."""
    root = request.getfixturevalue("tmp_path_factory").getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER") is not None:
        root = root.parent          # the session's, above each worker's
    root = root / "shared"
    (root / "locks").mkdir(parents=True, exist_ok=True)
    return shared_result(root, _key(request), "session", compute)
