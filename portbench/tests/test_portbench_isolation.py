"""Nothing of portbench loads JAX or the JAX package, and the plain
reference loads nothing of the program. Module names are compared by
their whole top-level name: ``icd_tpu_torch`` begins with ``icd_tpu``
and is not it."""

import os
import pkgutil
import subprocess
import sys

import portbench

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def _modules(package):
    out = [package]
    path = [os.path.join(ROOT, *package.split("."))]
    for info in pkgutil.walk_packages(path, package + "."):
        if ".tests" not in info.name:
            out.append(info.name)
    return out


def _loaded_after(imports):
    code = ("import importlib, sys\n"
            "for name in {!r}:\n"
            "    importlib.import_module(name)\n"
            "print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))"
            ).format(imports)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(out.stdout.split())


def test_portbench_loads_no_jax():
    loaded = _loaded_after(["portbench.run"] + _modules("portbench"))
    assert not loaded & {"jax", "jaxlib", "flax", "icd_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(_modules("portbench.reference"))
    assert not loaded & {"jax", "jaxlib", "flax", "icd_tpu", "icd_tpu_torch"}
    folder = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                assert "icd_tpu" not in f.read(), name


def test_the_package_is_found():
    assert os.path.samefile(os.path.dirname(portbench.__file__),
                            os.path.join(ROOT, "portbench"))
