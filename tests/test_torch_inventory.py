"""The port is complete against the JAX package: every module of
tilawa_tpu/ has its counterpart in tilawa_tpu_torch/, every TILAWA_*
switch the JAX package reads is read by the port, and pyproject.toml names
the port's entry point beside each of the JAX package's.

Modules and switches are read from the source (the file trees, and the
environment reads found by parsing each module): nothing of the JAX
package is imported.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "tilawa_tpu"
PORT_PKG = ROOT / "tilawa_tpu_torch"
SOURCES = ("*.py", "*.cpp")

# The JAX package's switches that the port reads under another name, and why.
RENAMED = {
    # the port's runner writes its own results file, never the JAX package's
    "TILAWA_RESULTS_DIR": "TILAWA_TORCH_RESULTS_DIR",
}


def modules(pkg: Path) -> set[str]:
    return {str(p.relative_to(pkg)) for pattern in SOURCES for p in pkg.rglob(pattern)}


def _is_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ") or \
        (isinstance(node, ast.Name) and node.id == "environ")


def _literal(node) -> str | None:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) \
        else None


def env_reads(source: str) -> set[str]:
    """The TILAWA_* names that `source` reads from the environment:
    getenv(NAME), environ.get(NAME), environ[NAME] and NAME in environ."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        name = None
        if isinstance(node, ast.Call) and node.args:
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "getenv") or \
                    (isinstance(f, ast.Name) and f.id == "getenv") or \
                    (isinstance(f, ast.Attribute) and f.attr == "get" and _is_environ(f.value)):
                name = _literal(node.args[0])
        elif isinstance(node, ast.Subscript) and _is_environ(node.value):
            name = _literal(node.slice)
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.In) and _is_environ(node.comparators[0]):
            name = _literal(node.left)
        if name and name.startswith("TILAWA_"):
            names.add(name)
    return names


def package_env_reads(pkg: Path) -> set[str]:
    return set().union(*(env_reads(p.read_text(encoding="utf-8")) for p in pkg.rglob("*.py")))


def test_every_jax_module_has_a_port_counterpart():
    jax_modules = modules(JAX_PKG)
    assert len(jax_modules) >= 70 and "native/edlib.cpp" in jax_modules
    assert sorted(jax_modules - modules(PORT_PKG)) == []


def test_every_jax_switch_is_read_by_the_port():
    jax_reads, port_reads = package_env_reads(JAX_PKG), package_env_reads(PORT_PKG)
    assert "TILAWA_STREAM_TTA" in jax_reads and "TILAWA_INT16_UPLOAD" in jax_reads
    assert sorted({RENAMED.get(n, n) for n in jax_reads} - port_reads) == []
    for old in RENAMED:
        assert old not in port_reads   # the port never writes into the JAX package's results


@pytest.mark.parametrize("source,names", [
    ('os.getenv("TILAWA_A", "")', {"TILAWA_A"}),
    ('os.environ.get(\n    "TILAWA_B")', {"TILAWA_B"}),
    ('x = os.environ["TILAWA_C"]', {"TILAWA_C"}),
    ('"TILAWA_D" in os.environ', {"TILAWA_D"}),
    ('getenv("TILAWA_E")', {"TILAWA_E"}),
    ('os.getenv("HOME"); print("TILAWA_F")', set()),
])
def test_env_reads_finds_each_form(source, names):
    assert env_reads("import os\nfrom os import getenv\n" + source) == names


def test_the_guard_fails_on_a_missing_module_or_switch(tmp_path):
    """A port without one of the JAX package's files, or without one of its
    switches, is found."""
    jax_pkg, port = tmp_path / "jax", tmp_path / "port"
    for pkg in (jax_pkg, port):
        (pkg / "pipeline").mkdir(parents=True)
        (pkg / "pipeline" / "predict.py").write_text('import os\nos.getenv("TILAWA_X")\n')
    (jax_pkg / "pipeline" / "stream.py").write_text('import os\nos.getenv("TILAWA_Y", "")\n')
    assert modules(jax_pkg) - modules(port) == {"pipeline/stream.py"}
    assert package_env_reads(jax_pkg) - package_env_reads(port) == {"TILAWA_Y"}


def test_every_jax_entry_point_has_a_port_counterpart():
    """pyproject.toml names tilawa-torch-X beside each tilawa-X, and each
    of the port's targets imports and is callable."""
    import importlib
    import tomllib

    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    jax_names = [n for n in scripts if not n.startswith("tilawa-torch-")]
    assert len(jax_names) == 4
    for name in jax_names:
        target = scripts[name.replace("tilawa-", "tilawa-torch-", 1)]
        module, func = target.split(":")
        assert module.startswith("tilawa_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), func))
