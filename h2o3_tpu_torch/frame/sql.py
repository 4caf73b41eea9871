"""SQL import — the port of ``h2o3_tpu/frame/sql.py``.

Reference: ``water/jdbc/SQLManager.java`` (h2o-py's ``import_sql_table``
and ``import_sql_select``). Python's DB-API stands in for JDBC:
``sqlite:<path>`` URLs connect through the standard ``sqlite3``, and any
other driver through a user's ``connection_factory``.
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame


def _connect(connection_url: str, connection_factory=None):
    if connection_factory is not None:
        return connection_factory(connection_url)
    if connection_url.startswith(("sqlite:", "sqlite3:")):
        import sqlite3
        path = connection_url.split(":", 1)[1].lstrip("/")
        # keep absolute paths absolute (sqlite:///tmp/x.db)
        if connection_url.count("/") >= 3 \
                or connection_url.startswith("sqlite:/"):
            path = "/" + path if not path.startswith("/") else path
        return sqlite3.connect(path)
    raise ValueError(
        f"unsupported connection url {connection_url!r}: built-in support is "
        "sqlite:<path>; pass connection_factory=<callable> for other DB-API "
        "drivers (the reference's JDBC drivers are likewise user-supplied)")


def _rows_to_frame(cols, rows, key=None, device=None) -> Frame:
    """A frame of the fetched rows (all-number columns float32, others
    categorical), put into the DKV under ``key``."""
    n = len(rows)
    arrays = {}
    for i, name in enumerate(cols):
        vals = [r[i] for r in rows]
        numeric = all(v is None or isinstance(v, (int, float)) for v in vals)
        if numeric:
            arr = np.array([np.nan if v is None else float(v) for v in vals],
                           np.float32)
        else:
            arr = np.array(["" if v is None else str(v) for v in vals],
                           dtype=object)
        arrays[name] = arr
    if n == 0:
        raise ValueError("query returned no rows")
    frame = Frame.from_arrays(arrays, key=key, device=device)
    if frame.key:
        from h2o3_tpu_torch.utils.registry import DKV
        DKV.put(frame.key, frame)
    return frame


def import_sql_select(connection_url: str, select_query: str,
                      username: str | None = None, password: str | None = None,
                      connection_factory=None, key: str | None = None,
                      device=None) -> Frame:
    """h2o-py ``import_sql_select``: run a SELECT, build a frame."""
    conn = _connect(connection_url, connection_factory)
    try:
        cur = conn.cursor()
        cur.execute(select_query)
        cols = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    return _rows_to_frame(cols, rows, key=key, device=device)


def import_sql_table(connection_url: str, table: str,
                     columns: list[str] | None = None,
                     username: str | None = None, password: str | None = None,
                     fetch_mode: str = "SINGLE", num_chunks: int = 4,
                     connection_factory=None, key: str | None = None,
                     device=None) -> Frame:
    """h2o-py ``import_sql_table``: fetch a whole table, or ``columns``.

    ``fetch_mode`` and ``num_chunks`` are taken for h2o-py's signature. One
    process reads the table in one SELECT: the reference's DISTRIBUTED
    mode splits its scan into rowid ranges read in rowid order, so on a
    sqlite URL that mode orders the one SELECT by ``rowid`` (a covering
    index would otherwise set the order; a view's rowid is NULL)."""
    if not table.replace("_", "").replace(".", "").isalnum():
        raise ValueError(f"suspicious table name {table!r}")
    key = key or table          # default destination key = table name
    collist = ", ".join(columns) if columns else "*"
    order = (" ORDER BY rowid" if fetch_mode.upper() == "DISTRIBUTED"
             and connection_factory is None else "")
    return import_sql_select(
        connection_url, f"SELECT {collist} FROM {table}{order}",  # noqa: S608
        connection_factory=connection_factory, key=key, device=device)
