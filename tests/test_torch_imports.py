"""The port stands alone: every rsn_torch module, and chip_smoke.py's,
imports in a fresh interpreter whose import system refuses rsn (the JAX
package, jax-free modules included), rsn's tools/, jax, flax, optax, PIL
and matplotlib (the card machine has no matplotlib)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("rsn", "tools", "jax", "jaxlib", "flax", "optax", "PIL",
           "matplotlib")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
import rsn_torch

mods = ["rsn_torch"] + [m.name for m in pkgutil.walk_packages(
    rsn_torch.__path__, "rsn_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401
print(len(mods), sorted(k for k in sys.modules
                        if k.split(".")[0] in BLOCKED))
"""


def test_port_and_chip_smoke_import_nothing_of_rsn_jax_or_pil():
    res = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    count, loaded = res.stdout.split(" ", 1)
    assert int(count) >= 25
    assert loaded.strip() == "[]"


def test_blocker_refuses_the_jax_package():
    """The guard itself: importing an rsn module under it fails."""
    code = _CODE.replace("import rsn_torch\n", "import rsn.configs\n", 1)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "the port imported rsn" in res.stderr
