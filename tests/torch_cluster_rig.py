"""Shared rig of the port's cluster tests (tests/test_torch_rpc.py,
tests/test_torch_fragments.py, tests/test_torch_cn_tn.py): the port's
services on the CPU beside the JAX package's.

The per-connection handler threads of a fragment server or a TN live as
long as the client's pooled socket, which spans tests under a
module-scoped rig; they are registered with the concurrency sanitizer
as the JAX package's `ServiceThreads` registers its own, and every
service is stopped (its threads joined) by the fixture that started it.
"""

import pytest
import torch

from matrixone_tpu.utils import san


def register_daemons() -> None:
    for prefix in ("pt-frag-conn", "pt-tn-conn"):
        san.daemon(prefix,
                   "per-connection handler of a port service: lives as "
                   "long as the client's pooled socket (spans tests under "
                   "a module-scoped rig); joined by the service's stop()")


register_daemons()


@pytest.fixture(autouse=True)
def port_faults_disarmed():
    """No drill leaks an armed fault point of the port's injector."""
    from matrixone_tpu_torch.utils.fault import INJECTOR
    yield
    INJECTOR.clear()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test processes run at once: torch's own pool in each would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tn_pair(tmp_path):
    """A port TN on a LocalFS directory and two CN replicas of it."""
    from matrixone_tpu_torch.cluster import RemoteCatalog, TNService
    d = str(tmp_path / "pt_cntn")
    tn = TNService(data_dir=d, device="cpu").start()
    cat1 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=d)
    cat2 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=d)
    yield tn, cat1, cat2
    cat1.close()
    cat2.close()
    assert tn.stop() == []


@pytest.fixture
def ref_pair(tmp_path):
    """The JAX package's TN and two CN replicas of it."""
    from matrixone_tpu.cluster import RemoteCatalog, TNService
    d = str(tmp_path / "mo_cntn")
    tn = TNService(data_dir=d).start()
    cat1 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=d)
    cat2 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=d)
    yield tn, cat1, cat2
    cat1.close()
    cat2.close()
    tn.stop()


def sync(*cats):
    ts = max(c.committed_ts for c in cats)
    for c in cats:
        c.consumer.wait_ts(ts)


def sessions(pair, port: bool):
    from matrixone_tpu.frontend import Session as JSession
    from matrixone_tpu_torch.frontend import Session as TSession
    _tn, c1, c2 = pair
    if port:
        return TSession(catalog=c1, device="cpu"), \
            TSession(catalog=c2, device="cpu")
    return JSession(catalog=c1), JSession(catalog=c2)
