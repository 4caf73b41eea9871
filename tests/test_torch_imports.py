"""The port never imports JAX or the JAX package: importing every module of
``h2o3_tpu_torch``, and every module ``chip_smoke.py`` imports (at its top
and inside its functions), leaves neither ``jax`` nor ``h2o3_tpu`` in
``sys.modules``. Each check runs in a fresh interpreter, since this test
process has both loaded."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, sys
for name in {names!r}:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('jax', 'jaxlib', 'h2o3_tpu'))))
"""


def _port_modules() -> list[str]:
    pkg = ROOT / "h2o3_tpu_torch"
    names = []
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


def _chip_smoke_imports() -> list[str]:
    """chip_smoke itself and every module its import statements name, at
    any depth of the file (the phases import the port inside functions)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {"chip_smoke"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return sorted(names)


def _loaded_after_importing(names: list[str]) -> list[str]:
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(names=names)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("what,names", [
    ("h2o3_tpu_torch", _port_modules()),
    ("chip_smoke.py", _chip_smoke_imports()),
])
def test_port_imports_neither_jax_nor_the_jax_package(what, names):
    assert len(names) > 1
    assert _loaded_after_importing(names) == [], what


def test_the_probe_covers_every_tree_builder_and_treeshap():
    """The import probe walks the whole package: the tree family's modules
    (TreeSHAP, calibration and DART in gbm and xgboost, the decision tree,
    uplift DRF and the isolation forests) are among those it imports."""
    assert {"h2o3_tpu_torch.genmodel.treeshap",
            "h2o3_tpu_torch.models.decision_tree",
            "h2o3_tpu_torch.models.uplift", "h2o3_tpu_torch.models.isofor",
            "h2o3_tpu_torch.models.xgboost", "h2o3_tpu_torch.convert"} \
        <= set(_port_modules())


def test_the_probe_covers_the_dkv_and_orchestration():
    """The DKV, the grid's combo key and every orchestration module are
    among the modules the probe imports."""
    assert {"h2o3_tpu_torch.utils.registry",
            "h2o3_tpu_torch.persist.recovery",
            "h2o3_tpu_torch.orchestration",
            *(f"h2o3_tpu_torch.orchestration.{m}" for m in (
                "parallel_build", "scheduler", "grid", "leaderboard",
                "stacked_ensemble", "automl", "segments"))} \
        <= set(_port_modules())


def test_the_probe_covers_the_text_path_and_udfs():
    """The text path's modules (the parser and its native loader, the
    frame utilities, the string functions, tokenize, Word2Vec, Grep) and
    the UDF loader are among the modules the probe imports."""
    assert {"h2o3_tpu_torch.frame.parse", "h2o3_tpu_torch.frame.native_csv",
            "h2o3_tpu_torch.frame.utils", "h2o3_tpu_torch.rapids.strings",
            "h2o3_tpu_torch.rapids.advprims",
            "h2o3_tpu_torch.models.word2vec",
            "h2o3_tpu_torch.models.grep_algo",
            "h2o3_tpu_torch.utils.udf"} <= set(_port_modules())


def test_the_probe_covers_the_data_plane():
    """The streaming ingest, the binary formats, SQL, the persist backends
    and snapshots, the memory meter and the Cleaner are among the modules
    the probe imports."""
    assert {"h2o3_tpu_torch.ingest", "h2o3_tpu_torch.ingest.encode",
            "h2o3_tpu_torch.ingest.pipeline", "h2o3_tpu_torch.frame.binfmt",
            "h2o3_tpu_torch.frame.sql", "h2o3_tpu_torch.persist.cloud",
            "h2o3_tpu_torch.persist.frame_io", "h2o3_tpu_torch.utils.memory",
            "h2o3_tpu_torch.utils.cleaner"} <= set(_port_modules())



def test_the_probe_covers_persistence_and_genmodel():
    """Binary models, recovery, and every genmodel module (MOJOs, Generic,
    the real H2O-3 readers, tools, pipelines, the POJO and the C++
    scorer's loader) are among the modules the probe imports."""
    assert {"h2o3_tpu_torch.persist.model_io",
            "h2o3_tpu_torch.persist.recovery",
            *(f"h2o3_tpu_torch.genmodel.{m}" for m in (
                "mojo", "generic", "mojo_ref", "mojo_ref2", "tools",
                "pipeline", "codegen", "native_scorer", "treeshap"))} \
        <= set(_port_modules())


#: the observability and ops slice's modules, held to the list above
OPS_MODULES = ["h2o3_tpu_torch.utils." + m for m in (
    "lockwitness", "telemetry", "tracing", "timeline", "costs",
    "compile_cache", "profiling", "incidents", "flight", "health",
    "blackbox")] + ["h2o3_tpu_torch.ops_plane." + m for m in (
        "actions", "remediate", "tenancy")] + [
    "h2o3_tpu_torch.ops_plane", "h2o3_tpu_torch.ops.map_reduce"]


def test_the_observability_modules_are_among_the_imported():
    assert set(OPS_MODULES) <= set(_port_modules())
