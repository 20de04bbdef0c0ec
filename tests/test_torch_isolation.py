"""The port stands alone: gsavatar_torch and chip_smoke.py import nothing of
JAX or of the JAX package, nor Pillow, matplotlib only inside a function,
and OpenCV only inside the functions of the wrappers of its video I/O and
ArUco detection (`motion/streams.py`, which the card's machine cannot run:
it has neither package); the tooling imports without any of them; no module
builds or imports a GPU toolchain at
import time, the entry points refuse to run without a GPU unless the
caller asks for the CPU, and a kernel library's name follows every source
it is built from. The port's test helper puts every test process's torch
on one thread."""
import ast
import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_dist_workers  # noqa: F401  (torch on one thread)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gsavatar', 'cv2',
             'PIL')
# the audit events of starting a process or loading a native library
AUDITED = ('subprocess.Popen', 'os.posix_spawn', 'os.exec', 'os.system',
           'os.fork', 'ctypes.dlopen')
PORT_FILES = sorted((ROOT / 'gsavatar_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']
# the one module that may import OpenCV, and only inside its functions
CV2_WRAPPERS = ('gsavatar_torch/motion/streams.py',)
# the serving path's modules, which must import without OpenCV
SERVING = ('gsavatar_torch.apps.ar_render', 'gsavatar_torch.apps.body_replace',
           'gsavatar_torch.apps.capture_and_record',
           'gsavatar_torch.apps.render_series', 'gsavatar_torch.camera.live',
           'gsavatar_torch.motion.series', 'gsavatar_torch.motion.streams')


def _imports(path: Path):
    """(module, inside a function) of each import statement."""
    tree = ast.parse(path.read_text(), str(path))
    inner = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in inner) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or '', id(node) in inner


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    """No import of JAX, the JAX package, OpenCV (but inside the
    functions of the wrappers) or Pillow; matplotlib only inside a
    function."""
    rel = str(path.relative_to(ROOT))
    bad = [m for m, in_function in _imports(path)
           if (m.split('.')[0] in FORBIDDEN
               and not (m == 'cv2' and in_function and rel in CV2_WRAPPERS))
           or (m.split('.')[0] == 'matplotlib' and not in_function)]
    assert not bad, f"{rel} imports {bad}"


# the tooling's modules, which must import without OpenCV, Pillow or
# matplotlib (the card's machine has none of them)
TOOLING = ('gsavatar_torch.tooling', 'gsavatar_torch.tooling.build_dataset',
           'gsavatar_torch.tooling.cliff', 'gsavatar_torch.tooling.skeleton',
           'gsavatar_torch.utils.draw', 'gsavatar_torch.utils.contours',
           'gsavatar_torch.smpl.tools', 'gsavatar_torch.native')


def test_tooling_imports_without_opencv_pillow_or_matplotlib():
    """In a fresh interpreter where `import cv2`, `import PIL` and `import
    matplotlib` fail, the tooling's modules import, and none of the three
    is loaded."""
    code = (
        "import json, sys\n"
        "for m in ('cv2', 'PIL', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {TOOLING!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]"
        " in ('cv2', 'PIL', 'matplotlib') and sys.modules[k] is not None)))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_import_pulls_in_no_jax_triton_or_build():
    """Importing every module of the port, in a fresh interpreter, loads
    no JAX, no gsavatar, no OpenCV or Pillow, no triton, and compiles
    nothing (neither the kernels nor the JPEG decoder): an audit hook in
    the child records every process it starts and every library it loads
    while the port's modules are imported, and there must be none. The
    hook watches the importing process itself, not the shared build
    directory, which other test workers write into at the same time. The
    third-party packages the port imports are loaded before the hook is
    installed: their own start-up (numpy.testing runs lscpu) is not the
    port's."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import numpy, numpy.testing, scipy.spatial, "
        "scipy.spatial.transform, torch\n"
        f"WATCH = {AUDITED!r}\n"
        "seen = []\n"
        "sys.addaudithook(lambda ev, args: seen.append([ev, repr(args)]) "
        "if ev in WATCH else None)\n"
        "import gsavatar_torch\n"
        "for m in pkgutil.walk_packages(gsavatar_torch.__path__, "
        "'gsavatar_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN + ('triton',)!r})\n"
        "serving = sorted(k for k in sys.modules if k in "
        f"{SERVING!r})\n"
        "print(json.dumps({'modules': bad, 'events': seen, "
        "'serving': serving}))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'modules': [], 'events': [], 'serving': sorted(SERVING)}


def _tiny_setup():
    from gsavatar_torch.config import load_config
    from gsavatar_torch.data.synthetic import SyntheticDataset
    cfg = load_config(["dataset.img_hw=[32,32]", "dataset.n_verts=256",
                       "dataset.n_points=128", "dataset.train_frames=[0,1,1]",
                       "model.gaussian.capacity=256"])
    return cfg, SyntheticDataset(cfg['dataset'], 'train')


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    from gsavatar_torch.device import resolve_device
    from gsavatar_torch.inference import InferenceScene, init_state
    cfg, ds = _tiny_setup()
    with pytest.raises(RuntimeError, match='GPU'):
        resolve_device()
    with pytest.raises(RuntimeError, match='GPU'):
        init_state(cfg, ds)
    state = init_state(cfg, ds, device='cpu')
    with pytest.raises(RuntimeError, match='GPU'):
        InferenceScene(cfg, ds.metadata, ds.assets, state)
    scene = InferenceScene(cfg, ds.metadata, ds.assets, state, device='cpu')
    assert scene.device.type == 'cpu'
    from gsavatar_torch.scene import Scene
    with pytest.raises(RuntimeError, match='GPU'):
        Scene(cfg)
    assert Scene(cfg, device='cpu').device.type == 'cpu'


def test_k1_wrapper_takes_plain_version_only_for_cpu_tensors():
    from gsavatar_torch.ops.rasterizer import composite
    pair_data = torch.zeros((0, 12))
    tile_start = torch.zeros(2, dtype=torch.int32)
    before = composite.composite_pairs_fwd.launches
    out = composite.composite_pairs_fwd(pair_data, tile_start, 1)
    assert out.shape == (1, 8, 256)
    assert float(out[0, 4].min()) == 1.0           # empty tile: T = 1
    assert composite.composite_pairs_fwd.launches == before
    with pytest.raises(ValueError):
        composite.composite_pairs_fwd(pair_data.to('meta'),
                                      tile_start.to('meta'), 1)


def test_kernel_library_name_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its .cu and of every header under
    csrc/: editing a shared header renames (so rebuilds) each library,
    editing another kernel's source renames only that one. Checked on a
    copy of csrc/."""
    import shutil
    from gsavatar_torch import kernels
    csrc = tmp_path / 'csrc'
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, 'CSRC', csrc)
    names = kernels.sources()
    assert {'composite_fwd', 'composite_bwd', 'segsum'} <= set(names)
    before = {n: kernels._target(n) for n in names}
    header = csrc / 'composite_common.cuh'
    header.write_text(header.read_text() + '\n// edited\n')
    after = {n: kernels._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    seg = csrc / 'segsum.cu'
    seg.write_text(seg.read_text() + '\n// edited\n')
    again = {n: kernels._target(n) for n in names}
    assert again['segsum'] != after['segsum']
    assert again['composite_fwd'] == after['composite_fwd']


def test_test_helper_puts_torch_on_one_thread():
    """Importing tests/torch_dist_workers.py, as every port test module
    does, leaves this worker's torch on one thread and the thread-count
    variables at 1 for the processes it starts: a child's torch starts on
    one thread too."""
    assert torch.get_num_threads() == 1
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        assert os.environ[var] == '1', var
    out = subprocess.run(
        [sys.executable, '-c', 'import torch; print(torch.get_num_threads())'],
        capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == '1'
