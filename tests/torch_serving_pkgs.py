"""The serving and operations modules of both packages side by side, for
the tests that run one scenario through the JAX package and through the
port (tests/test_torch_serving.py, test_torch_motrace.py and
test_torch_ops_surface.py).

A scenario is a function of an `SPkg`: it uses only the attributes
below, so the same code drives either package, and it records what it
compares (row sets, cache outcomes, counter deltas) in `pkg.seen`.
`run_both` runs it for each package and holds the port's record equal
to the reference's, step by step.  The port's sessions run on the CPU.
"""

import dataclasses
import types

from matrixone_tpu import queryservice as jqs
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.serving import admission as jadm
from matrixone_tpu.serving import plan_cache as jpc
from matrixone_tpu.storage import blockcache as jbc
from matrixone_tpu.storage import engine as jengine
from matrixone_tpu.storage import fileservice as jfs
from matrixone_tpu.storage import merge_sched as jsched
from matrixone_tpu.utils import fault as jfault
from matrixone_tpu.utils import metrics as jM
from matrixone_tpu.utils import motrace as jmotrace
from matrixone_tpu.utils import trace as jtrace
import matrixone_tpu.serving as jserving
from matrixone_tpu_torch import queryservice as tqs
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.serving import admission as tadm
from matrixone_tpu_torch.serving import plan_cache as tpc
from matrixone_tpu_torch.storage import blockcache as tbc
from matrixone_tpu_torch.storage import engine as tengine
from matrixone_tpu_torch.storage import fileservice as tfs
from matrixone_tpu_torch.storage import merge_sched as tsched
from matrixone_tpu_torch.utils import fault as tfault
from matrixone_tpu_torch.utils import metrics as tM
from matrixone_tpu_torch.utils import motrace as tmotrace
from matrixone_tpu_torch.utils import trace as ttrace
import matrixone_tpu_torch.serving as tserving


def _jax_deadline_scope():
    from matrixone_tpu.cluster.rpc import deadline_scope
    return deadline_scope


@dataclasses.dataclass
class SPkg:
    name: str
    mods: types.SimpleNamespace
    seen: list = dataclasses.field(default_factory=list)

    def __getattr__(self, attr):
        try:
            return getattr(self.__dict__["mods"], attr)
        except AttributeError:
            raise AttributeError(attr) from None

    @property
    def Engine(self):
        return self.engine.Engine

    def session(self, eng=None, **kw):
        eng = eng if eng is not None else self.Engine()
        if self.name == "jax":
            return JSession(catalog=eng, **kw)
        return TSession(catalog=eng, device="cpu", **kw)

    def rows(self, s, sql: str, params=None) -> list:
        """Run `sql`; record and return its rows."""
        got = s.execute(sql, params).rows()
        self.seen.append((sql, got))
        return got

    def note(self, label: str, value):
        """Record a value the packages must agree on; return it."""
        self.seen.append((label, value))
        return value


def packages():
    jax = SPkg("jax", types.SimpleNamespace(
        engine=jengine, fs=jfs, blockcache=jbc, merge_sched=jsched,
        serving=jserving, plan_cache=jpc, admission=jadm, M=jM,
        motrace=jmotrace, trace=jtrace, fault=jfault, queryservice=jqs,
        deadline_scope=_jax_deadline_scope()))
    port = SPkg("port", types.SimpleNamespace(
        engine=tengine, fs=tfs, blockcache=tbc, merge_sched=tsched,
        serving=tserving, plan_cache=tpc, admission=tadm, M=tM,
        motrace=tmotrace, trace=ttrace, fault=tfault, queryservice=tqs,
        deadline_scope=tadm.deadline_scope))
    return [jax, port]


def run_both(scenario, **kw):
    """-> {package name: the scenario's return value}, after holding the
    port's recorded values equal to the reference's, step by step."""
    out, seen = {}, {}
    for pkg in packages():
        out[pkg.name] = scenario(pkg, **kw)
        seen[pkg.name] = pkg.seen
    assert len(seen["port"]) == len(seen["jax"]), (seen["port"],
                                                   seen["jax"])
    for (label, got), (_label, want) in zip(seen["port"], seen["jax"]):
        assert got == want, (label, got, want)
    return out
