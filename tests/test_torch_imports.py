"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``, nor an ``examples/torch_*.py`` entry point) imports
JAX or the JAX package. Checked on the AST,
so nothing is imported to check it."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
] + sorted((ROOT / "examples").glob("torch_*.py"))
_BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in _BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_modules_to_check():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    examples = {p.name for p in FILES if p.parent.name == "examples"}
    assert examples == {f"torch_{n}.py" for n in (
        "quickstart", "serve_spec", "rl_math", "rl_code")}


LAUNCH_TOOLING = ("mesh", "sharding", "workloads", "analysis", "dryrun",
                  "hillclimb")


def test_launch_tooling_is_checked():
    """The dry run's six modules are among the files walked above (the
    JAX-free counterparts of ``repro.launch``'s), and so is the kernels'
    work registry their meta branches report to."""
    launch = ROOT / "src" / "repro_torch" / "launch"
    for name in LAUNCH_TOOLING:
        assert launch / f"{name}.py" in FILES, name
    assert ROOT / "src" / "repro_torch" / "kernels" / "work.py" in FILES


def _reference_module_strings(path: Path):
    """``"repro..."`` module names handed to ``-m`` in an argument list,
    or to ``importlib.import_module``/``__import__``: a subprocess or a
    dynamic import of the JAX package, which the AST import walk above
    cannot see (a shard subprocess spawned as ``repro.history.service``
    would put the JAX package on the port's path)."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def is_ref(node):
        return (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and (node.value == "repro"
                     or node.value.startswith("repro.")))

    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for a, b in zip(elts, elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and is_ref(b)):
                    yield b.value, b.lineno
        elif isinstance(node, ast.Call) and node.args and is_ref(node.args[0]):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value, node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_spawns_and_loads_no_reference_module(path):
    bad = list(_reference_module_strings(path))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_reference_module_strings_are_caught(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('import importlib, sys\n'
                   'cmd = [sys.executable, "-m", "repro.history.service"]\n'
                   'importlib.import_module("repro.fault")\n'
                   'ok = [sys.executable, "-m", "repro_torch.history.service"]\n')
    assert [m for m, _ in _reference_module_strings(bad)] == [
        "repro.history.service", "repro.fault"]


def test_shard_subprocess_runs_the_port():
    """The service's subprocess shards run ``python -m
    repro_torch.history.service``; a client syncs from them."""
    from repro_torch.history.client import HistoryClient
    from repro_torch.history.service import HistoryService

    svc = HistoryService.spawn_subprocess(1, window_size=8)
    c = None
    try:
        args = svc.procs[0].args
        assert args[1:3] == ["-m", "repro_torch.history.service"]
        c = HistoryClient(svc.book, worker_id="w0", rpc_timeout=5.0)
        c.publish_rollout("p0", [1, 2, 3, 1, 2, 3], 0, response_len=6)
        assert c.flush(timeout=10.0)
        c.sync()
        assert c.pack_for("p0") is not None
    finally:
        if c is not None:
            c.close(flush_timeout=0.5)
        svc.stop()
