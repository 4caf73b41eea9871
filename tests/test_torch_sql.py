"""The port's SQL import (``h2o3_tpu_torch/frame/sql.py``) against the JAX
package's (``h2o3_tpu/frame/sql.py``): the same sqlite file, written from
a numpy seed, through ``import_sql_select`` and ``import_sql_table`` (whole
table, a column list, DISTRIBUTED mode over a table, a covering index and
a view, a user's connection factory) gives the same names, types, domains, NA positions and values
(exact), in the same row order."""

import sqlite3

import numpy as np
import pytest
import torch

from h2o3_tpu.frame import sql as jsql
from h2o3_tpu_torch import import_sql_select, import_sql_table, set_device
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import same_frame


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


@pytest.fixture
def db(tmp_path, rng):
    path = str(tmp_path / "t.db")
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE flights (id INTEGER, dist REAL, carrier TEXT,"
                " delayed INTEGER)")
    n = 997
    rows = [(int(i), None if i % 13 == 0 else float(rng.normal(700, 200)),
             None if i % 17 == 0 else f"C{int(rng.integers(0, 5))}",
             int(rng.integers(0, 2))) for i in range(n)]
    con.executemany("INSERT INTO flights VALUES (?, ?, ?, ?)", rows)
    con.commit()
    con.close()
    return path


def test_select_equals_reference(db):
    url = f"sqlite:///{db}"
    q = "SELECT id, dist, carrier FROM flights WHERE delayed = 1"
    pf = import_sql_select(url, q, key="sel")
    same_frame(pf, jsql.import_sql_select(url, q, key="jsel"))
    assert DKV.get("sel") is pf
    assert pf.types == {"id": "int", "dist": "real", "carrier": "enum"}


@pytest.mark.parametrize("kw", [{}, {"columns": ["carrier", "dist"]},
                                {"fetch_mode": "DISTRIBUTED",
                                 "num_chunks": 3}])
def test_table_equals_reference(db, kw):
    url = f"sqlite:{db}"
    pf = import_sql_table(url, "flights", **kw)
    jf = jsql.import_sql_table(url, "flights", **kw)
    assert pf.key == "flights" and DKV.get("flights") is pf
    same_frame(pf, jf)


@pytest.mark.parametrize("source", ["flights", "flights_v"])
def test_distributed_order_under_index_and_view(db, source):
    """DISTRIBUTED mode gives the reference's rowid order, though a
    covering index would have the plain scan follow the index, and takes a
    view (whose rowid is NULL) as the reference does."""
    con = sqlite3.connect(db)
    con.execute("CREATE INDEX by_carrier ON flights (carrier)")
    con.execute("CREATE VIEW flights_v AS SELECT * FROM flights")
    con.commit()
    con.close()
    url = f"sqlite:{db}"
    kw = {"columns": ["carrier"], "fetch_mode": "DISTRIBUTED"}
    pf = import_sql_table(url, source, **kw)
    same_frame(pf, jsql.import_sql_table(url, source, **kw))


def test_connection_factory_and_refusals(db):
    seen = []

    def factory(url):
        seen.append(url)
        return sqlite3.connect(db)

    pf = import_sql_table("custom://x", "flights", connection_factory=factory,
                          fetch_mode="DISTRIBUTED")
    assert seen == ["custom://x"] and pf.nrows == 997
    with pytest.raises(ValueError, match="unsupported connection url"):
        import_sql_table("postgres://h/db", "flights")
    with pytest.raises(ValueError, match="suspicious table name"):
        import_sql_table(f"sqlite:{db}", "flights; DROP TABLE x")
    with pytest.raises(ValueError, match="no rows"):
        import_sql_select(f"sqlite:{db}",
                          "SELECT * FROM flights WHERE id < 0")
