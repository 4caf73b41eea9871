"""The port's session entry points (``h2o3_tpu_torch/session.py``), Scope
(``utils/scope.py``) and the Extensions SPI (``utils/extensions.py``) on
the CPU.

- ``init`` boots the port's REST server and binds a client, ``cluster``
  reports, ``connect`` attaches (to the port's server or the JAX
  package's), ``shutdown`` tears down; the multi-host arguments of the
  JAX package's ``init`` are refused by name.
- Scope: the same script of enter/track/untrack/exit on the port's DKV and
  on the JAX package's leaves the same keys.
- Extensions: ``ModelBuilder.train`` reports ``model_build_start`` and
  ``model_build_end`` to listeners and extensions, as the JAX package's
  does; an extension's REST route and capability are served; a broken
  listener or init never breaks the build or the node;
  ``$H2O3TPU_EXTENSIONS`` modules self-register.
"""

import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu.utils import scope as jscope
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch import session
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.api import H2OServer
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.utils import extensions as ext
from h2o3_tpu_torch.utils import scope as pscope
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    ext.reset()
    yield
    ext.reset()
    session.shutdown()
    DKV.clear()


def _frame(rng, key="ext_fr"):
    fr = Frame.from_arrays(
        {"a": rng.normal(size=120).astype(np.float32),
         "y": rng.normal(size=120).astype(np.float32)}, key=key)
    DKV.put(fr.key, fr)
    return fr


# -- init / connect / cluster / shutdown ----------------------------------------

def test_init_connect_cluster_shutdown():
    assert h2o3_tpu_torch.init is session.init
    client = h2o3_tpu_torch.init(port=0)
    assert h2o3_tpu_torch.init() is client          # once per process
    assert h2o3_tpu_torch.connection() is client
    st = h2o3_tpu_torch.cluster()
    assert st["cloud_size"] >= 1 and st["version"] == h2o3_tpu_torch.__version__
    c2 = h2o3_tpu_torch.connect(session._server.url)
    assert c2.cloud_status()["cloud_healthy"]
    h2o3_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match="not connected"):
        h2o3_tpu_torch.cluster()
    assert h2o3_tpu_torch.connection() is None


def test_init_falls_back_to_a_free_port_unless_strict():
    busy = H2OServer(port=0).start()
    try:
        client = session.init(port=busy.port)
        assert session._server.port != busy.port
        assert client.cloud_status()["cloud_healthy"]
        session.shutdown()
        with pytest.raises(OSError):
            session.init(port=busy.port, strict_port=True)
    finally:
        busy.stop()


@pytest.mark.parametrize("kw", [dict(coordinator_address="10.0.0.1:1234"),
                                dict(num_processes=2),
                                dict(process_id=0)])
def test_multi_host_arguments_are_refused_by_name(kw):
    """init's multi-host arguments as the JAX package's init takes them: a
    coordinator without the cloud's size and this process's rank is
    refused by name before any connection is tried; the size or the rank
    alone, without a coordinator, joins no cloud and starts the
    one-process server, in both packages."""
    from h2o3_tpu_torch.parallel import distributed
    if "coordinator_address" in kw:
        with pytest.raises(ValueError, match="num_processes"):
            session.init(port=0, **kw)
        assert session.connection() is None
        return
    from h2o3_tpu import session as jsession
    try:
        client = session.init(port=0, **kw)
        jclient = jsession.init(port=0, **kw)
        assert client.cloud_status()["cloud_healthy"]
        assert jclient.cloud_status()["cloud_healthy"]
        assert client.cloud_status()["cloud_size"] == 1
        assert not distributed.is_multiprocess()
    finally:
        session.shutdown()
        jsession.shutdown()


def test_connect_to_the_reference_server():
    from h2o3_tpu.api import H2OServer as JServer
    js = JServer(port=0).start()
    try:
        c = session.connect(js.url)
        assert c.cloud_status()["cloud_name"] == "h2o3_tpu"
        assert session.cluster()["cloud_healthy"]
    finally:
        js.stop()
    with pytest.raises(OSError):
        session.connect("http://127.0.0.1:1")


# -- Scope ---------------------------------------------------------------------

def _scope_script(mod, store):
    """Scope calls over ``store``; the key sets after each step."""
    out = []
    store.put("pre", 1)
    mod.enter()
    store.put("a", 2)
    store.put("b", 3)
    mod.track("side")
    store.put("side", 4)
    mod.enter()
    store.put("c", 5)
    mod.untrack("c")
    mod.exit("c")
    out.append(sorted(store.keys()))
    mod.exit("a")
    out.append(sorted(store.keys()))
    with mod.scope("kept"):
        store.put("kept", 6)
        store.put("temp", 7)
    out.append(sorted(store.keys()))
    store.clear()
    return out


def test_scope_leaves_the_keys_the_references_does():
    assert _scope_script(pscope, DKV) == _scope_script(jscope, JDKV)
    assert _scope_script(pscope, DKV)[-1] == ["a", "kept", "pre"]


def test_scope_is_per_thread():
    import threading
    pscope.enter()
    seen = []

    def other():
        pscope.enter()
        DKV.put("t_key", 1)
        pscope.exit()
        seen.append("t_key" in DKV)

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    DKV.put("main_key", 1)
    pscope.exit()
    assert seen == [False] and "main_key" not in DKV


# -- the Extensions SPI -----------------------------------------------------------

def test_listener_receives_model_events(rng):
    events = []
    ext.add_listener(lambda e, **kw: events.append((e, kw)))
    fr = _frame(rng)
    m = GBM(ntrees=2, max_depth=2).train(y="y", training_frame=fr)
    names = [e for e, _ in events]
    assert names == ["model_build_start", "model_build_end"]
    start, end = events[0][1], events[1][1]
    assert start["algo"] == "gbm" and start["frame"] == "ext_fr"
    assert end == {"algo": "gbm", "model": m.key, "job": start["job"]}
    assert end["model"] in DKV


def test_events_are_the_references(rng):
    """The same build in both packages reports the same events with the
    same fields (keys and job ids differ by construction)."""
    from h2o3_tpu.frame.frame import Frame as JFrame
    from h2o3_tpu.models.gbm import GBM as JGBM
    from h2o3_tpu.utils import extensions as jext
    cols = {"a": rng.normal(size=64).astype(np.float32),
            "y": rng.normal(size=64).astype(np.float32)}
    got, want = [], []
    ext.add_listener(lambda e, **kw: got.append((e, sorted(kw))))
    jext.reset()
    jext.add_listener(lambda e, **kw: want.append((e, sorted(kw))))
    try:
        GBM(ntrees=1, max_depth=2).train(
            y="y", training_frame=Frame.from_arrays(cols, key="k"))
        JGBM(ntrees=1, max_depth=2).train(
            y="y", training_frame=JFrame.from_arrays(cols, key="k"))
    finally:
        jext.reset()
    assert got == want


def test_broken_listener_does_not_break_training(rng):
    def bad(e, **kw):
        raise RuntimeError("boom")
    ext.add_listener(bad)
    m = GBM(ntrees=2, max_depth=2).train(y="y",
                                         training_frame=_frame(rng, "e2"))
    assert m.training_metrics is not None


class _ProbeExt(ext.H2OExtension):
    name = "probe"

    def __init__(self):
        self.inited = 0
        self.events = []

    def init(self):
        self.inited += 1

    def routes(self):
        def handler(h):
            h._reply({"__meta": {"schema_type": "ProbeV3"}, "probe": "ok"})
        return [(r"/3/Probe", "GET", handler)]

    def on_event(self, event, **info):
        self.events.append(event)


def test_extension_rest_route_and_capabilities():
    probe = ext.register(_ProbeExt())
    s = H2OServer(port=0).start()
    try:
        assert probe.inited == 1
        assert "cloud_up" in probe.events
        with urllib.request.urlopen(s.url + "/3/Probe") as r:
            assert json.loads(r.read())["probe"] == "ok"
        with urllib.request.urlopen(s.url + "/3/Capabilities") as r:
            caps = json.loads(r.read())["capabilities"]
        assert {"name": "probe", "module": "extension"} in caps
        assert {"name": "gbm", "module": "core"} in caps
    finally:
        s.stop()


def test_broken_extension_init_is_disabled():
    class Bad(ext.H2OExtension):
        name = "bad"

        def init(self):
            raise RuntimeError("no")

    ext.register(Bad())
    ext.init_all()
    assert all(e.name != "bad" for e in ext.extensions())


def test_env_discovery(tmp_path, monkeypatch):
    """$H2O3TPU_EXTENSIONS modules are imported and self-register (the
    ServiceLoader analog)."""
    mod = tmp_path / "my_port_ext.py"
    mod.write_text(
        "from h2o3_tpu_torch.utils import extensions as ext\n"
        "class E(ext.H2OExtension):\n"
        "    name = 'from-env'\n"
        "ext.register(E())\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("H2O3TPU_EXTENSIONS", "my_port_ext, no_such_module_x")
    try:
        ext.load_env_extensions()
        assert [e.name for e in ext.extensions()] == ["from-env"]
    finally:
        sys.modules.pop("my_port_ext", None)
    assert os.environ["H2O3TPU_EXTENSIONS"].startswith("my_port_ext")


def test_the_import_probe_covers_serving_and_rest():
    """The no-JAX import probe (``tests/test_torch_imports.py``) walks the
    slice's modules too."""
    from test_torch_imports import _port_modules
    assert {"h2o3_tpu_torch.serving.scorer", "h2o3_tpu_torch.serving.service",
            "h2o3_tpu_torch.serving.replicas", "h2o3_tpu_torch.api.server",
            "h2o3_tpu_torch.api.schemas", "h2o3_tpu_torch.api.client",
            "h2o3_tpu_torch.session", "h2o3_tpu_torch.utils.scope",
            "h2o3_tpu_torch.utils.extensions"} <= set(_port_modules())
