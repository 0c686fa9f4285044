"""Import guard: the PyTorch port and chip_smoke.py import neither JAX nor
the JAX package (sdr_receiver_dvb_t2_tpu), not even its numpy-only modules;
the port keeps its own copies of those."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(ROOT)) for p in
               (ROOT / "sdr_receiver_dvb_t2_tpu_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
BANNED = ("jax", "jaxlib", "sdr_receiver_dvb_t2_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"
