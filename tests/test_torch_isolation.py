"""The PyTorch port stands alone: importing it and every one of its
modules (the native library's binding, the threaded parser and the
loader's pack and transfer threads among them) pulls in neither JAX nor
the JAX package, and no source file of the port (nor ``chip_smoke.py``
and ``tools/``) names them in an import.  Importing compiles nothing and starts no
thread."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dmlc_core_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import dmlc_core_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
new = ("dmlc_core_tpu_torch.native", "dmlc_core_tpu_torch.native.build",
       "dmlc_core_tpu_torch.utils.threaded_iter",
       "dmlc_core_tpu_torch.pipeline.loader", "dmlc_core_tpu_torch.data.parser",
       "dmlc_core_tpu_torch.io", "dmlc_core_tpu_torch.io.input_split",
       "dmlc_core_tpu_torch.io.wrappers", "dmlc_core_tpu_torch.io.recordio",
       "dmlc_core_tpu_torch.io.filesys", "dmlc_core_tpu_torch.io.uri",
       "dmlc_core_tpu_torch.io.indexed_recordio_split",
       "dmlc_core_tpu_torch.io.single_file_split",
       "dmlc_core_tpu_torch.data.iterators",
       "dmlc_core_tpu_torch.pipeline.page_cache",
       "dmlc_core_tpu_torch.pipeline.fingerprint",
       "dmlc_core_tpu_torch.utils.checkpoint",
       "dmlc_core_tpu_torch.utils.serializer",
       "dmlc_core_tpu_torch.utils.memory_io",
       "dmlc_core_tpu_torch.utils.faults",
       "dmlc_core_tpu_torch.io.remote_filesys",
       "dmlc_core_tpu_torch.io.fscli",
       "dmlc_core_tpu_torch.parallel.tracker",
       "dmlc_core_tpu_torch.parallel.rabit",
       "dmlc_core_tpu_torch.utils.durable",
       "dmlc_core_tpu_torch.parallel.launcher.wrapper",
       "dmlc_core_tpu_torch.parallel.launcher.bootstrap",
       "dmlc_core_tpu_torch.parallel.launcher.batch",
       "dmlc_core_tpu_torch.parallel.launcher.ssh",
       "dmlc_core_tpu_torch.parallel.launcher.mesos",
       "dmlc_core_tpu_torch.parallel.launcher.yarn",
       "dmlc_core_tpu_torch.parallel.launcher.yarn_am",
       "dmlc_core_tpu_torch.embed", "dmlc_core_tpu_torch.embed.exchange",
       "dmlc_core_tpu_torch.embed.table",
       "dmlc_core_tpu_torch.examples.train_embed_shard",
       "dmlc_core_tpu_torch.transport.endpoints",
       "dmlc_core_tpu_torch.serving.fleet",
       "dmlc_core_tpu_torch.serving.fleet.registry",
       "dmlc_core_tpu_torch.serving.fleet.rollout")
assert all(n in sys.modules for n in new), new
import threading
assert threading.active_count() == 1, threading.enumerate()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "dmlc_core_tpu"))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]", f"port imported {bad}"
    assert "kernels: built" not in out.stderr       # nothing compiled
    assert "native: built" not in out.stderr


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    tools = os.path.join(REPO, "tools")
    files += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
              if f.endswith(".py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "optax",
                                           "dmlc_core_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {m}"


def test_every_module_names_its_counterpart_or_role():
    """Each module's docstring says which JAX module it ports, or why it
    has none."""
    for path in _sources():
        if not path.startswith(PKG + os.sep):     # chip_smoke.py, tools/
            continue
        doc = ast.get_docstring(ast.parse(open(path).read())) or ""
        assert "dmlc_core_tpu/" in doc or "counterpart" in doc.lower(), \
            os.path.relpath(path, REPO)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_lookup_names_the_jax_package(path):
    """A ``sys.modules`` lookup by name (the recorder, the sampler, the
    faults, the trace found without an import) names the port's module:
    in a process that also loaded the JAX package, a JAX name would reach
    the JAX package's state."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in ("get", "pop")
                and isinstance(f.value, ast.Attribute)
                and f.value.attr == "modules"):
            continue
        for arg in node.args[:1]:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                assert arg.value.split(".")[0] != "dmlc_core_tpu", \
                    f"{os.path.relpath(path, REPO)} looks up {arg.value}"


#: the diagnosis modules (ROADMAP A.12.e) and the JAX module each ports
A12E_MODULES = {"critical_path.py": "critical_path.py",
                "profiling.py": "profiling.py",
                "diagnose.py": "diagnose.py",
                "graph_introspect.py": "xla_introspect.py"}


@pytest.mark.parametrize("name", sorted(A12E_MODULES))
def test_diagnosis_modules_stand_alone(name):
    """Each diagnosis module is among the checked sources, imports nothing
    of JAX or the JAX package, names its JAX counterpart, and looks a
    module up in ``sys.modules`` only by the port's name."""
    path = os.path.join(PKG, "telemetry", name)
    assert path in _sources()
    test_source_imports_nothing_of_jax(path)
    test_no_module_lookup_names_the_jax_package(path)
    doc = ast.get_docstring(ast.parse(open(path).read())) or ""
    assert f"dmlc_core_tpu/telemetry/{A12E_MODULES[name]}" in doc
    looked_up = [node.args[0].value for node in ast.walk(
        ast.parse(open(path).read())) if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get" and node.args
        and isinstance(node.func.value, ast.Attribute)
        and node.func.value.attr == "modules"
        and isinstance(node.args[0], ast.Constant)]
    assert all(m.startswith("dmlc_core_tpu_torch.") or m == "torch"
               for m in looked_up), looked_up


#: the data-parallel modules (ROADMAP A.7.a's dp half) and the transfer
#: probe (A.14), and what each names as its counterpart
DP_MODULES = {"parallel/__init__.py": "dmlc_core_tpu/parallel",
              "parallel/mesh.py": "dmlc_core_tpu/parallel/mesh.py",
              "parallel/collectives.py":
                  "dmlc_core_tpu/parallel/collectives.py",
              "pipeline/probe.py": "bench.py",
              # model and pipeline parallelism (A.7.a2)
              "parallel/pipeline.py": "dmlc_core_tpu/parallel/pipeline.py",
              "models/sharding.py": "dmlc_core_tpu/models/train.py"}

_DP_PROBE = r"""
import sys, threading
import dmlc_core_tpu_torch.parallel
import dmlc_core_tpu_torch.parallel.pipeline
import dmlc_core_tpu_torch.models.sharding
import dmlc_core_tpu_torch.pipeline.probe
import torch.distributed as dist
assert not dist.is_initialized()
assert threading.active_count() == 1, threading.enumerate()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "dmlc_core_tpu")))
"""


@pytest.mark.parametrize("name", sorted(DP_MODULES))
def test_dp_modules_stand_alone(name):
    """Each module is among the checked sources, imports nothing of JAX
    or the JAX package, and names its counterpart."""
    path = os.path.join(PKG, *name.split("/"))
    assert path in _sources()
    test_source_imports_nothing_of_jax(path)
    test_no_module_lookup_names_the_jax_package(path)
    doc = ast.get_docstring(ast.parse(open(path).read())) or ""
    assert DP_MODULES[name] in doc


def test_dp_imports_pull_in_no_jax_and_start_nothing():
    """Importing the mesh, the collectives and the probe alone pulls in
    no JAX, starts no thread and joins no process group."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _DP_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_dp_worker_imports_nothing_of_jax():
    """The ranks of the CPU dp tests import only torch, numpy and the
    port: the JAX side runs in the pytest process."""
    test_source_imports_nothing_of_jax(
        os.path.join(REPO, "tests", "torch_dp_worker.py"))


#: the fleet's control plane (ROADMAP A.11.a) and what each names as its
#: counterpart
FLEET_MODULES = {
    "transport/endpoints.py": "dmlc_core_tpu/transport/endpoints.py",
    "serving/fleet/__init__.py": "dmlc_core_tpu/serving/fleet",
    "serving/fleet/registry.py": "dmlc_core_tpu/serving/fleet/registry.py",
    "serving/fleet/rollout.py": "dmlc_core_tpu/serving/fleet/rollout.py"}

_FLEET_PROBE = r"""
import sys, threading
import dmlc_core_tpu_torch.serving.fleet
import dmlc_core_tpu_torch.transport.endpoints
assert threading.active_count() == 1, threading.enumerate()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "dmlc_core_tpu")))
"""


@pytest.mark.parametrize("name", sorted(FLEET_MODULES))
def test_fleet_modules_stand_alone(name):
    """Each module is among the checked sources, imports nothing of JAX
    or the JAX package, and names its counterpart."""
    path = os.path.join(PKG, *name.split("/"))
    assert path in _sources()
    test_source_imports_nothing_of_jax(path)
    test_no_module_lookup_names_the_jax_package(path)
    doc = ast.get_docstring(ast.parse(open(path).read())) or ""
    assert FLEET_MODULES[name] in doc


def test_fleet_imports_pull_in_no_jax_and_start_nothing():
    """Importing the fleet package and the endpoint lists alone pulls in
    no JAX and starts no thread (the registry, its sweep and the rollout
    watch start only with ``start()``)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _FLEET_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
