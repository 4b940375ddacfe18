"""Rules of the port package `matrixone_tpu_torch` and of chip_smoke.py.

  * neither imports `jax` or anything of `matrixone_tpu` (an AST scan,
    so a lazy import inside a function counts too), nor a package the
    card machine lacks (`pyarrow`, `lz4`, `zstandard`, `pandas`,
    `grpc`), and ingest (LOAD DATA, external CSV tables, `load_file()`)
    runs in an interpreter where `import pyarrow` fails;
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
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                           "time_sorted_search.py")]
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
            if top in ("jax", "jaxlib", "matrixone_tpu", "ml_dtypes",
                       "pyarrow", "lz4", "zstandard", "pandas", "grpc"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default resolves to it")
    from matrixone_tpu_torch import convert, resolve_device
    from matrixone_tpu_torch.cluster import FragmentServer, TNService
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.storage.fileservice import MemoryFS
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
             lambda: compile_plan(None, engine),
             # the host peers' fragment servers and the TN (its view
             # maintenance) run on a device too
             lambda: FragmentServer(engine),
             lambda: TNService(fs=MemoryFS())]
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
    f = FragmentServer(engine, device="cpu")
    assert f.device.type == "cpu"
    f.stop()


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
           "assert 'pyarrow' not in sys.modules",
           "print('ok', len(sys.modules))"])
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-2000:]


def test_ingest_runs_where_pyarrow_cannot_import(tmp_path):
    """LOAD DATA from a stage, an external CSV table and `load_file()`
    in a fresh interpreter whose `import pyarrow` raises, as on the
    card machine, which has no pyarrow."""
    (tmp_path / "p.csv").write_text('id,name,price\n1,"a,b",12.50\n'
                                    '2,c,3.01\n')
    code = "\n".join([
        "import sys",
        "sys.modules['pyarrow'] = None",
        "from matrixone_tpu_torch.frontend import Session",
        "s = Session(device='cpu')",
        f"s.execute(\"create stage st url = 'file://{tmp_path}'\")",
        "s.execute('create table t (id bigint primary key, "
        "name varchar(8), price decimal(15,2))')",
        "n = s.execute(\"load data infile 'stage://st/p.csv' into table "
        "t\").affected",
        "s.execute(\"create external table x (id bigint, name varchar(8)) "
        "location 'stage://st/p.csv'\")",
        "rows = s.execute('select t.name, price from t, x "
        "where t.id = x.id order by t.id').rows()",
        "txt = s.execute(\"select load_file('stage://st/p.csv')\")"
        ".rows()[0][0]",
        "assert 'pyarrow' not in sys.modules or "
        "sys.modules['pyarrow'] is None",
        "print(n, rows, len(txt))"])
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[:1] == ["2"]
    assert "[('a,b', 12.5), ('c', 3.01)]" in r.stdout


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
