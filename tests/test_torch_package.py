"""Rules of the port package `matrixone_tpu_torch` and of chip_smoke.py.

  * neither imports `jax` or anything of `matrixone_tpu` (an AST scan,
    so a lazy import inside a function counts too);
  * entry points taking host data default to CUDA and raise a clear
    RuntimeError without it, unless the caller names the CPU;
  * importing the package builds no kernel and does not initialise CUDA.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "matrixone_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 15, files
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "matrixone_tpu", "ml_dtypes"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default resolves to it")
    from matrixone_tpu_torch import convert, resolve_device
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.utils import datagen
    from matrixone_tpu_torch.vectorindex import ivf_flat
    from matrixone_tpu_torch.vm.compile import compile_plan
    from matrixone_tpu_torch.vm.process import ExecContext
    from matrixone_tpu_torch.worker import WorkerCore
    x = np.zeros((300, 8), np.float32)
    engine = Engine()
    calls = [lambda: resolve_device(),
             lambda: WorkerCore(),
             lambda: ivf_flat.build(x, nlist=4),
             lambda: datagen.make_clustered(100, 8, 4),
             lambda: convert.tensor_from_numpy(x),
             lambda: Session(),
             lambda: Session(catalog=engine),
             # the engine's scans run in an execution context, which
             # resolves its device the same way
             lambda: ExecContext(catalog=engine),
             lambda: compile_plan(None, engine)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the CPU is used when named
    assert resolve_device("cpu").type == "cpu"
    assert WorkerCore(device="cpu").device.type == "cpu"
    data, q = datagen.make_clustered(100, 8, 4, device="cpu")
    assert data.shape == (100, 8) and q.shape == (4, 8)
    assert data.device.type == "cpu"
    assert Session(device="cpu").device.type == "cpu"
    assert ExecContext(catalog=engine, device="cpu").device.type == "cpu"


def test_import_builds_nothing():
    """Import every module of the port in a fresh interpreter: no
    extension is built or loaded and CUDA is not initialised."""
    mods = []
    for path in _port_files():
        if path.startswith(PKG):
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            mods.append(rel[:-len(".__init__")] if rel.endswith(
                "__init__") else rel)
    code = "\n".join(
        ["import importlib, sys, torch"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["from matrixone_tpu_torch.ops import cuda_kernels as CK",
           "assert CK._built['ops'] is None",
           "assert not torch.cuda.is_initialized()",
           "assert not torch.ops.loaded_libraries",
           "assert 'jax' not in sys.modules",
           "print('ok', len(sys.modules))"])
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-2000:]


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
