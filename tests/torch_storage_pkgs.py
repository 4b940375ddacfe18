"""The storage modules of both packages side by side, for the tests that
run one scenario through the JAX package and through the port, each on
a file service of its own, and compare what every step returned.

A scenario is a function of a `Pkg`: it uses only the attributes below,
so the same code drives either package, and it records every row set
it reads in `pkg.seen`.  `run_both` runs it for each package (the JAX
side on its per-operator path, MO_PLAN_FUSION=0, with the Pallas
kernels in interpret mode, MO_HAND_KERNELS=1) and returns both records.
"""

import dataclasses
import os

import pytest

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.storage import blockcache as jblockcache
from matrixone_tpu.storage import engine as jengine
from matrixone_tpu.storage import fileservice as jfs
from matrixone_tpu.storage import merge_sched as jsched
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.storage import blockcache as tblockcache
from matrixone_tpu_torch.storage import engine as tengine
from matrixone_tpu_torch.storage import fileservice as tfs
from matrixone_tpu_torch.storage import merge_sched as tsched


@dataclasses.dataclass
class Pkg:
    name: str
    engine: object           # the storage.engine module
    fs: object               # the storage.fileservice module
    blockcache: object
    merge_sched: object
    root: str = ""           # this package's own directory
    seen: list = dataclasses.field(default_factory=list)

    @property
    def Engine(self):
        return self.engine.Engine

    def session(self, eng=None, fs=None):
        eng = eng if eng is not None else self.Engine(fs)
        if self.name == "jax":
            return JSession(catalog=eng)
        return TSession(catalog=eng, device="cpu")

    def local(self, sub: str = "store"):
        return self.fs.LocalFS(os.path.join(self.root, sub))

    def rows(self, s, sql: str) -> list:
        """Run `sql`; record and return its rows."""
        got = s.execute(sql).rows()
        self.seen.append((sql, got))
        return got


def packages(tmp_path):
    return [Pkg("jax", jengine, jfs, jblockcache, jsched,
                root=str(tmp_path / "jax")),
            Pkg("port", tengine, tfs, tblockcache, tsched,
                root=str(tmp_path / "port"))]


def run_both(scenario, tmp_path, **kw):
    """-> {package name: the scenario's return value}, after holding the
    port's recorded row sets equal to the reference's, step by step."""
    out, seen = {}, {}
    for pkg in packages(tmp_path):
        out[pkg.name] = scenario(pkg, **kw)
        seen[pkg.name] = pkg.seen
    assert len(seen["port"]) == len(seen["jax"])
    for (sql, got), (_sql, want) in zip(seen["port"], seen["jax"]):
        assert got == want, (sql, got, want)
    return out


@pytest.fixture
def storage_env(monkeypatch):
    """The reference's per-operator path with the Pallas kernels in
    interpret mode, a cold block cache in both packages before and
    after, and default cache budgets."""
    monkeypatch.setenv("MO_PLAN_FUSION", "0")
    monkeypatch.setenv("MO_HAND_KERNELS", "1")
    for v in ("MO_BLOCK_CACHE_MB", "MO_DEVICE_CACHE_MB",
              "MO_BLOCK_CACHE_DISABLE", "MO_LAZY_SEGMENTS",
              "MO_SCAN_PREFETCH", "MO_MERGE_SCHED"):
        monkeypatch.delenv(v, raising=False)
    for bc in (jblockcache, tblockcache):
        bc.CACHE.clear()
        bc.CACHE.reset_stats()
    yield
    for bc in (jblockcache, tblockcache):
        bc.CACHE.clear()
        bc.CACHE.reset_stats()
