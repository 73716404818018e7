"""The port imports neither JAX nor anything of the reference package.

Three gates: the static import walker (``tools/layercheck.py``) over
``repro_torch``; a subprocess that imports every module of the port with
``jax`` and ``repro`` made unimportable; and an AST check of
``chip_smoke.py``, which drives the port on the card.
"""

import ast
import os
import pkgutil
import subprocess
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC = os.path.join(_ROOT, "src")
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_layercheck_contract_is_clean():
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    try:
        from layercheck import check_contract
    finally:
        sys.path.pop(0)
    assert check_contract("repro_torch", _FORBIDDEN, src=_SRC) == []


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    assert "repro_torch.checkpoint.manager" in mods
    assert "repro_torch.kernels.decode_attention.ops" in mods
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(" f"{mods!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=_SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=_ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    path = os.path.join(_ROOT, "chip_smoke.py")
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith("repro_torch") for n in names)
    bad = [n for n in names
           if n.split(".")[0] in _FORBIDDEN]
    assert bad == []
