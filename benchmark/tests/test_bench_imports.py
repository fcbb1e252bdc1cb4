"""What a run loads: nothing of JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and a
reference that imports nothing of the program."""

import ast
import subprocess
import sys
import textwrap

from benchmark.harness import core

REFERENCE = core.BENCH / "reference"


def _python(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, cwd=core.ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    out = _python(f"""
        import sys, torch
        sys.path.insert(0, ".")
        torch.set_num_threads(2)
        from pathlib import Path
        from benchmark.harness import core
        from benchmark.tests import tiny
        bench = tiny.write(Path({str(tmp_path)!r}))
        files = core.Files([Path({str(tmp_path)!r}), core.BENCH])
        for cell in sorted(tiny.CELLS):
            tiny.run(bench, files, cell, trace=True)
        assert "nas_3d_unet_tpu_torch" in sys.modules
        print(core.forbidden_modules())
    """)
    assert out == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nas_3d_unet_tpu_torch_x", sys)
    assert "nas_3d_unet_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert core.forbidden_modules() == ["flax"]


def test_the_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "nas_3d_unet_tpu_torch", *core.FORBIDDEN), (path, n)
    out = _python("""
        import sys
        sys.path.insert(0, ".")
        import benchmark.reference.net, benchmark.reference.ops
        import benchmark.reference.serve, benchmark.reference.train
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"nas_3d_unet_tpu_torch", "nas_3d_unet_tpu", "jax"}))
    """)
    assert out == "[]"
