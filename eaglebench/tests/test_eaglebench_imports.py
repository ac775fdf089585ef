"""What the harness loads: no module whose top-level name, compared
whole, is jax, jaxlib, flax or repro (the JAX package; repro_torch is
the port), nothing read under benchmarks/ or benchmarks_torch/, and the
reference loads nothing of the program."""
import ast
import subprocess
import sys

from eaglebench import spec

HERE = spec.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_nothing_forbidden():
    for path in HERE.rglob("*.py"):
        top = {m.split(".")[0] for m in _imports(path)}
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)
        text = path.read_text()
        if path.parent.name != "tests":
            assert "benchmarks_torch" not in text and "benchmarks/" not in \
                text, path
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in {m.split(".")[0] for m in
                                     _imports(path)}


_DRIVE = """
import sys, time, torch
sys.path[:0] = [{src!r}, {root!r}]
sys.path.insert(0, {tests!r})
from conftest import tiny_route_cell
from eaglebench import run, spec
from eaglebench.drivers import route_open
torch.set_num_threads(1)
cell, cfg, mix = tiny_route_cell()
rec = route_open.run(cell, cfg, mix, seed=3, seconds=1.0, traced=True,
                     device=torch.device("cpu"), t_start=time.perf_counter(),
                     out_dir=__import__("pathlib").Path({tmp!r}))
for m in spec.benchmark()["per_layer"]:
    spec.metric(m["name"]).read(rec["ctx"])
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_nothing_forbidden(tmp_path):
    code = _DRIVE.format(src=str(spec.ROOT / "src"), root=str(spec.ROOT),
                         tests=str(HERE / "tests"), tmp=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(eval(p.stdout.split("LOADED", 1)[1]))
    assert not loaded & FORBIDDEN
    assert "repro_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(spec.ROOT / 'src')!r}, "
            f"{str(spec.ROOT)!r}]\n"
            "import eaglebench.reference.router\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    loaded = set(eval(p.stdout))
    assert not loaded & (FORBIDDEN | {"repro_torch"})
