"""The port's distributed primitives (`parallel/dist_query.py`) and its
slot mesh (`parallel/mesh.py`) against the JAX package's, on the CPU.

The JAX package runs its `shard_map` programs on the 8 virtual CPU
devices of its conftest; the port runs the same steps over 8 slots laid
on the one CPU (`simulated_slots(8)`), on the same numpy inputs.  The
counterparts of tests/test_parallel.py's five tests (the grouped
aggregate, the top-k, the shuffle, Q1, the shuffle's overflow error),
then the mesh itself and the scan's hash route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.parallel import dist_query as JDQ
from matrixone_tpu.parallel import make_mesh as jmake_mesh
from matrixone_tpu.parallel import replicate as jreplicate
from matrixone_tpu.parallel import shard_rows as jshard_rows
from matrixone_tpu_torch.parallel import dist_query as DQ
from matrixone_tpu_torch.parallel import mesh as MS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs six test processes at once (xdist): torch's own
    thread pool in each would oversubscribe the cores, and these tests'
    many small ops per shard are what it slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def meshes():
    with MS.simulated_slots(8):
        yield jmake_mesh(8), MS.make_mesh(8, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_sharded_group_aggregate(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(42)
    n, max_groups = 8 * 1024, 64
    keys = rng.integers(0, 40, n).astype(np.int64)
    vals = rng.integers(-50, 50, n).astype(np.int64)
    mask = rng.random(n) > 0.1
    want = JDQ.sharded_group_aggregate(
        jm, jshard_rows(jm, jnp.asarray(keys)),
        jshard_rows(jm, jnp.asarray(vals)),
        jshard_rows(jm, jnp.asarray(mask)), max_groups)
    got = DQ.sharded_group_aggregate(
        tm, MS.shard_rows(tm, _t(keys)), MS.shard_rows(tm, _t(vals)),
        MS.shard_rows(tm, _t(mask)), max_groups)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g in range(40):
        sel = (keys == g) & mask
        assert int(got[1][g]) == vals[sel].sum()
        assert int(got[2][g]) == sel.sum()


def test_sharded_topk(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(43)
    n, d, b, k = 8 * 512, 32, 4, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jd, ji = JDQ.sharded_topk(jm, jshard_rows(jm, jnp.asarray(x)),
                              jreplicate(jm, jnp.asarray(q)), k)
    td, ti = DQ.sharded_topk(tm, MS.shard_rows(tm, _t(x)), _t(q), k)
    oracle = np.argsort(((x[:, None].astype(np.float64)
                          - q[None].astype(np.float64)) ** 2).sum(-1),
                        axis=0)[:k].T
    for i in range(b):
        assert set(ti[i].tolist()) == set(oracle[i].tolist())
        assert set(ti[i].tolist()) == set(np.asarray(ji)[i].tolist())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                               rtol=1e-5, atol=1e-4)


def test_hash_shuffle_colocates_keys_as_the_reference(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(44)
    n = 8 * 256
    keys = rng.integers(0, 100, n).astype(np.int64)
    vals = np.arange(n, dtype=np.int64)
    jk, jv = JDQ.hash_shuffle(jm, jshard_rows(jm, jnp.asarray(keys)),
                              jshard_rows(jm, jnp.asarray(vals)))
    tk, tv = DQ.hash_shuffle(tm, MS.shard_rows(tm, _t(keys)),
                             MS.shard_rows(tm, _t(vals)))
    # slot p's received table is the reference's shard p, bit for bit
    np.testing.assert_array_equal(torch.cat(tk).numpy(), np.asarray(jk))
    np.testing.assert_array_equal(torch.cat(tv).numpy(), np.asarray(jv))
    owner = {}
    for p, (kp, vp) in enumerate(zip(tk, tv)):
        real = kp >= 0
        for key, v in zip(kp[real].tolist(), vp[real].tolist()):
            assert owner.setdefault(key, p) == p
            assert keys[v] == key
    assert sorted(torch.cat(tv)[torch.cat(tk) >= 0].tolist()) == \
        list(range(n))


def test_distributed_q1(meshes):
    from matrixone_tpu.utils import tpch as JT
    from matrixone_tpu_torch.utils import tpch as T
    jm, tm = meshes
    n = 8 * 1024
    arrays = T.gen_lineitem(n, seed=9)
    sel = arrays["l_shipdate"] <= 10471   # 1998-12-01 minus 90 days
    cols = {"flag": arrays["l_returnflag"].astype(np.int32),
            "status": arrays["l_linestatus"].astype(np.int32),
            "qty": arrays["l_quantity"], "price": arrays["l_extendedprice"],
            "disc": arrays["l_discount"], "tax": arrays["l_tax"],
            "mask": sel}
    want = JDQ.distributed_q1(
        jm, {k: jshard_rows(jm, jnp.asarray(v)) for k, v in cols.items()},
        n_flags=3, n_status=2)
    got = DQ.distributed_q1(
        tm, {k: MS.shard_rows(tm, _t(v)) for k, v in cols.items()},
        n_flags=3, n_status=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    oracle = T.q1_oracle(arrays)
    assert oracle == JT.q1_oracle(arrays)
    for (f, st), o in oracle.items():
        g = T.FLAG_CATS.index(f) * 2 + T.STATUS_CATS.index(st)
        assert int(got[0][g]) == o["sum_qty"]
        assert int(got[3][g]) == o["sum_charge"]
        assert int(got[4][g]) == o["count_order"]


def test_hash_shuffle_overflow_is_loud(meshes):
    jm, tm = meshes
    n = 64 * 8
    with pytest.raises(JDQ.ShuffleOverflow) as want:
        JDQ.hash_shuffle(jm, jnp.zeros((n,), jnp.int64),
                         jnp.arange(n, dtype=jnp.int64), cap_per_dest=8)
    k = MS.shard_rows(tm, torch.zeros(n, dtype=torch.int64))
    v = MS.shard_rows(tm, torch.arange(n, dtype=torch.int64))
    with pytest.raises(DQ.ShuffleOverflow) as got:
        DQ.hash_shuffle(tm, k, v, cap_per_dest=8)
    assert got.value.needed == want.value.needed == 64
    k2, v2 = DQ.hash_shuffle(tm, k, v, cap_per_dest=got.value.needed)
    kept = torch.cat(v2)[torch.cat(k2) != -1]
    assert sorted(kept.tolist()) == list(range(n))


# ------------------------------------------------------------- the mesh

def test_slots_and_collectives():
    assert MS.devices("cpu") == [torch.device("cpu")]
    with MS.simulated_slots(8):
        assert len(MS.devices("cpu")) == 8
        with MS.simulated_slots(3):
            assert len(MS.devices("cpu")) == 3
        mesh = MS.make_mesh(4, device="cpu")
        with pytest.raises(ValueError):
            MS.make_mesh(9, device="cpu")
    assert MS.devices("cpu") == [torch.device("cpu")]
    assert mesh.size == 4 and mesh.axis_name == "shard"
    parts = [torch.full((3,), float(i) + 0.1) for i in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(MS.psum(parts, "cpu"), want)    # slot order
    assert torch.equal(MS.pmax(parts, "cpu"), parts[3])
    assert MS.all_gather(parts, "cpu").tolist() == \
        torch.cat(parts).tolist()
    buckets = [[torch.tensor([10 * s + p]) for p in range(4)]
               for s in range(4)]
    got = MS.all_to_all(mesh, buckets)
    assert [g.tolist() for g in got] == \
        [[p, 10 + p, 20 + p, 30 + p] for p in range(4)]
    x = torch.arange(8)
    assert [r.tolist() for r in MS.shard_rows(mesh, x)] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(r is x for r in MS.replicate(mesh, x))  # no copy


def test_hash_route_tensor_equals_host_and_partitions():
    """The scan's hash route on a tensor key (as on the card) keeps the
    rows the host route and `assign_partitions` give the shard."""
    from matrixone_tpu_torch.storage import partition as partmod
    from matrixone_tpu_torch.vm import operators as O
    rng = np.random.default_rng(5)
    n, S = 4096, 8
    key = rng.integers(-2**62, 2**62, n).astype(np.int64)
    valid = rng.random(n) > 0.05
    spec = partmod.PartitionSpec("hash", "k", [f"p{i}" for i in range(S)])
    pid = partmod.assign_partitions(spec, key, valid)
    for s in range(S):
        host = O._route_keep(key, valid, S, s)
        dev = O._route_keep(_t(key), _t(valid), S, s)
        np.testing.assert_array_equal(dev.numpy(), host)
        np.testing.assert_array_equal(host, pid == s)
    arrays = {"k": _t(key), "r": np.arange(n)}
    validity = {"k": _t(valid), "r": np.ones(n, bool)}
    a2, v2, kept, moved = O._hash_route(arrays, validity, n, ("k", 3, S),
                                        False)
    assert kept == moved == int((pid == 3).sum())
    np.testing.assert_array_equal(a2["r"], np.flatnonzero(pid == 3))
