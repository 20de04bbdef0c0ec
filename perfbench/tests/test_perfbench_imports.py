"""Nothing the harness imports is JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole, so that `gsavatar_torch` is not taken for `gsavatar`."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_whole_names_are_compared():
    assert forbidden_modules(['gsavatar_torch', 'gsavatar_torch.train',
                              'jaxtyping', 'flaxen']) == []
    assert forbidden_modules(['gsavatar', 'gsavatar.ops', 'jax.numpy',
                              'jaxlib', 'flax.linen', 'numpy']) == \
        ['flax.linen', 'gsavatar', 'gsavatar.ops', 'jax.numpy', 'jaxlib']


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob('*.py'):
        bad = set(top_level_imports(path)) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    banned = set(FORBIDDEN) | {'gsavatar_torch'}
    for path in (HERE / 'reference').rglob('*.py'):
        bad = set(top_level_imports(path)) & banned
        assert not bad, f"{path} imports {bad}"


def test_a_driven_cell_loads_no_jax():
    """Drive a tiny cell on the CPU in a fresh process and read its
    sys.modules, as the benchmark does once its window has closed."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.tests.tiny import run_tiny\n"
        "from perfbench.run import forbidden_modules\n"
        "run_tiny('zju377_full.serve', seconds=0.5)\n"
        "print('FOUND', forbidden_modules(sys.modules))\n" % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == 'FOUND []'
