"""Statement scripts run through the JAX session and the port's, on the
CPU, compared step by step (shared by the tests/test_torch_*.py files
that hold the port's executor to the JAX package's).

A step is SQL text, optionally prefixed by `!` (the reference raises
here; every other step must succeed).  Each package runs the script on
an engine of its own; the JAX side runs its per-operator path
(MO_PLAN_FUSION=0) with the Pallas kernels in interpret mode
(MO_HAND_KERNELS=1).  Outcomes are equal when both raise an exception
of the same class, or both return the same column names, the same
`affected` count and the same rows: exactly, except that floats may
differ by the tolerance the caller states.
"""

import os
import shutil
import time

import pytest

from matrixone_tpu import native as jnative
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu_torch.frontend import Session as TSession
from torch_scripts import run_step, same_outcome


@pytest.fixture(scope="module")
def reference_env():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    yield
    mp.undo()


@pytest.fixture()
def reference_compiled(monkeypatch):
    """The reference's compiled route, established before a comparison
    that depends on it.  The reference builds its library through one
    shared temporary file (`native/build/libmo_native.so.tmp`), so when
    several test processes build it at once a loser's compile fails, and
    its `get_lib()` stays None for the rest of that process: its roaring
    bitmap then reports the numpy route's bytes.  This helper never
    builds: it waits until a build in flight has finished (no `.tmp`)
    and a library newer than its source is in place, then lets this
    process load that one (`get_lib` compiles only when the library is
    missing or stale), so it cannot collide with another process's build
    (the module's state is restored afterwards)."""
    deadline = time.monotonic() + 180
    while jnative.get_lib() is None and shutil.which("g++") \
            and time.monotonic() < deadline:
        time.sleep(0.5)
        if os.path.exists(jnative._SO + ".tmp") \
                or not os.path.exists(jnative._SO) \
                or os.path.getmtime(jnative._SO) \
                < os.path.getmtime(jnative._SRC):
            continue
        monkeypatch.setattr(jnative, "_tried", False)
        monkeypatch.setattr(jnative, "_lib", None)
    lib = jnative.get_lib()
    assert lib is not None and lib.mo_has_rbm and lib.mo_has_hnsw, \
        "g++ is here: the reference must load its compiled library"


def session(pkg, catalog=None):
    if pkg == "jax":
        return JSession() if catalog is None else JSession(catalog=catalog)
    return TSession(catalog=catalog, device="cpu")


def run_script(pkg, steps, sess=None):
    """-> (outcome of each step, the session)."""
    sess = sess if sess is not None else session(pkg)
    return [run_step(sess, s.lstrip("!")) for s in steps], sess


def assert_same(steps, rtol=None, atol=None, ordered=True, reset=None):
    """Run `steps` through both packages (calling `reset`, if given,
    before each package's run); every step's outcome must be equal, and
    `!` steps must raise in the reference.  -> the port's outcomes and
    session."""
    outs = []
    for pkg in ("jax", "port"):
        if reset is not None:
            reset()
        outs.append(run_script(pkg, steps))
    (want, _), (got, port) = outs
    for step, w, g in zip(steps, want, got):
        assert (w[0] == "err") == step.startswith("!"), (step, w)
        assert same_outcome(g, w, rtol, atol, ordered), (step, g, w)
    return got, port
