"""The port's DKV (``h2o3_tpu_torch/utils/registry.py``) against the JAX
package's (``h2o3_tpu/utils/registry.py``): the same sequence of
operations on a fresh ``KeyedStore`` of each package gives the same
results and key sets; and the key locks' semantics on the port's
``KeyLocks``: shared readers, an exclusive and reentrant writer, and no
deadlock for crossed multi-key sets. Every thread runs with a timeout, so
a hang fails its test instead of the suite."""

import sys
import threading
import time

import pytest

from h2o3_tpu.utils import registry as jreg
from h2o3_tpu_torch.utils import registry as preg


class Obj:
    """A value compared by identity, as the stores compare it."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"Obj({self.name})"


def _script(store, objs):
    """Every store operation, its results in order."""
    a, b, c = objs
    out = [store.put("a", a), store.put(None, b), store.put("b", b),
           store.get("a") is a, store.get("zz", "dflt"), store["b"] is b,
           "a" in store, "zz" in store, sorted(store.keys()),
           sorted(store)]
    with pytest.raises(KeyError):
        store["zz"]
    out += [store.replace_if("a", b, c), store.get("a") is a,
            store.replace_if("a", a, c), store.get("a") is c,
            store.replace_if("new", None, a), store.get("new") is a,
            store.remove("a", only_if=a), "a" in store,
            store.remove("a", only_if=c) is c, "a" in store,
            store.remove("missing"), store.remove("b") is b,
            sorted(k for k, _ in store.raw_items())]
    store.put("x", a)
    store.put("x", b)
    out += [store.get("x") is b, len(store.keys())]
    store.clear()
    out += [store.keys(), store.get("new")]
    return out


def test_the_stores_give_the_same_results():
    objs = [Obj(i) for i in range(3)]
    assert _script(preg.KeyedStore(), objs) == \
        _script(jreg.KeyedStore(), objs)


@pytest.mark.parametrize("keys", [["k1", "k2", "k1"], ["only"], []])
def test_put_remove_sequences_leave_the_same_keys(keys):
    stores = (preg.KeyedStore(), jreg.KeyedStore())
    for s in stores:
        for i, k in enumerate(keys):
            s.put(k, Obj(i))
        if keys:
            s.remove(keys[0])
    assert sorted(stores[0].keys()) == sorted(stores[1].keys())


def _run(target, timeout=10.0):
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


def _join(threads, timeout=10.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "a lock holder or waiter hung"


def test_readers_share_a_key():
    locks = preg.KeyLocks()
    inside = threading.Barrier(2, timeout=5.0)

    def reader():
        with locks.read("k"):
            inside.wait()       # both readers hold the lock at once

    _join([_run(reader), _run(reader)])


def test_a_writer_excludes_readers_and_writers_and_reenters():
    locks = preg.KeyLocks()
    order = []
    held = threading.Event()
    release = threading.Event()

    def writer():
        with locks.write("k"):
            with locks.write("k"):      # reentrant in its own thread
                with locks.read("k"):   # and reads under its write lock
                    held.set()
                    release.wait(5.0)
                    order.append("writer done")

    def other(kind):
        def run():
            held.wait(5.0)
            with getattr(locks, kind)("k"):
                order.append(kind)
        return run

    threads = [_run(writer), _run(other("read")), _run(other("write"))]
    held.wait(5.0)
    time.sleep(0.2)             # the others are waiting on the writer
    assert order == []
    release.set()
    _join(threads)
    assert order[0] == "writer done" and sorted(order[1:]) == ["read",
                                                               "write"]
    assert locks._state == {}


def test_crossed_multi_key_sets_do_not_deadlock():
    """Two threads that name the same keys in opposite orders, as write
    and read sets, many times over: one sorted acquisition each."""
    locks = preg.KeyLocks()
    done = []

    def worker(write, read):
        def run():
            for _ in range(200):
                with locks.locked(write=write, read=read):
                    pass
            done.append(1)
        return run

    _join([_run(worker(["a", "b"], ["c"])), _run(worker(["c"], ["b", "a"])),
           _run(worker(["b"], ["a"]))], timeout=30.0)
    assert len(done) == 3 and locks._state == {}


def test_unknown_and_none_keys_lock_fine():
    locks = preg.KeyLocks()
    with locks.write(None, "never-stored"):
        with locks.read(None):
            pass
    assert locks._state == {}


def test_a_write_lock_keeps_a_shared_counter_exact_under_contention():
    """More threads than cores, the interpreter switching threads every
    microsecond: a read-modify-write under the key's write lock loses no
    update, and the store's puts from every thread all land."""
    locks, store = preg.KeyLocks(), preg.KeyedStore()
    counter = [0]
    n_threads, n_iter = 16, 200

    def work(t):
        def run():
            for i in range(n_iter):
                with locks.write("counter"):
                    v = counter[0]
                    time.sleep(0)
                    counter[0] = v + 1
                store.put(f"k{t}_{i}", i)
        return run

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _join([_run(work(t)) for t in range(n_threads)], timeout=60.0)
    finally:
        sys.setswitchinterval(prev)
    assert counter[0] == n_threads * n_iter
    assert len(store.keys()) == n_threads * n_iter and locks._state == {}
