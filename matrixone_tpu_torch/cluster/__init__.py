"""The CN/TN split and the host peers: the port of the JAX package's
`cluster/`.

  * `frame.py`  the fabric's frame (JSON header + blob);
  * `rpc.py`    the resilient RPC fabric (pooled connections, retries,
                deadlines, circuit breakers, request dedup);
  * `wire.py`   columns on the fabric, in the WAL's insert format;
  * `tn.py`     the TN: storage, the commit pipeline and the logtail
                push (`TNService`, `LogtailHub`);
  * `cn.py`     a CN replica (`RemoteCatalog`, `LogtailConsumer`) and
                the fragment server its peers ship plan fragments to
                (`FragmentServer`, parallel/fragments.py).

Reference analogue: a TN owns storage and commits
(`pkg/tnservice`, `tae/rpc/handle.go:547`) and pushes the logtail
(`tae/logtail/service/server.go:192`); stateless CNs replay it and
serve snapshot reads (`pkg/vm/engine/disttae`).
"""

from matrixone_tpu_torch.cluster.cn import (CNService, FragmentServer,
                                            LogtailConsumer, RemoteCatalog,
                                            ReplicaBrokenError)
from matrixone_tpu_torch.cluster.tn import LogtailHub, TNService

__all__ = ["TNService", "LogtailHub", "CNService", "FragmentServer",
           "LogtailConsumer", "RemoteCatalog", "ReplicaBrokenError"]
