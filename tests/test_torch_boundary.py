"""The import boundary of the PyTorch port: ``tpuflow_torch`` and
``chip_smoke.py`` import neither JAX, Flax nor the JAX package (the port
runs where none of them is installed), read no ``TPUFLOW_*`` environment
variable (the port takes arguments for the JAX package's knobs), and the
package imports with JAX poisoned."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpuflow")


def _port_sources():
    root = os.path.join(REPO, "tpuflow_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


# Every package of the port, with its count of Python modules: a module
# dropped or left out of the scan fails the count.
PACKAGES = {"": 2, "ckpt": 6, "data": 4, "dist": 3, "flow": 8, "flows": 6,
            "infer": 11, "models": 9, "obs": 17, "ops": 5, "parallel": 7,
            "testing": 4, "train": 5, "utils": 4}


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_no_jax_or_jax_package_imports():
    sources = list(_port_sources())
    pkgs = {}
    for p in sources[:-1]:
        rel = os.path.relpath(os.path.dirname(p),
                              os.path.join(REPO, "tpuflow_torch"))
        pkgs[rel.strip(".")] = pkgs.get(rel.strip("."), 0) + 1
    assert pkgs == PACKAGES
    assert len(sources) == sum(PACKAGES.values()) + 1  # and chip_smoke.py
    bad = [
        f"{os.path.relpath(p, REPO)}:{line}: {mod}"
        for p in sources
        for mod, line in _imported_roots(p)
        if mod in FORBIDDEN
    ]
    assert not bad, "port imports JAX-side code:\n" + "\n".join(bad)


def _env_reads(src):
    """``(line, name)`` of every read of a ``TPUFLOW_*`` environment
    variable in the source ``src``: ``os.environ[...]``,
    ``os.environ.get(...)`` and its kin, ``os.getenv(...)``."""
    tree = ast.parse(src)

    def knob(node):
        return (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("TPUFLOW_"))

    def environ(node):
        return isinstance(node, ast.Attribute) and node.attr == "environ"

    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and environ(node.value)
                and knob(node.slice)):
            yield node.lineno, node.slice.value
        elif (isinstance(node, ast.Call) and node.args and knob(node.args[0])
              and isinstance(node.func, ast.Attribute)
              and (node.func.attr == "getenv" or environ(node.func.value))):
            yield node.lineno, node.args[0].value


def test_no_tpuflow_env_reads():
    bad = [f"{os.path.relpath(p, REPO)}:{line}: {name}"
           for p in _port_sources()
           for line, name in _env_reads(open(p, encoding="utf-8").read())]
    assert not bad, "port reads JAX-package knobs:\n" + "\n".join(bad)
    # The scan sees each form of such a read.
    probe = ("import os\nos.environ.get('TPUFLOW_FAULT')\n"
             "os.getenv('TPUFLOW_OBS_DIR')\nos.environ['TPUFLOW_ATTEMPT']\n")
    assert [n for _, n in sorted(_env_reads(probe))] == [
        "TPUFLOW_FAULT", "TPUFLOW_OBS_DIR", "TPUFLOW_ATTEMPT"]


def test_package_imports_with_jax_poisoned():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'tpuflow'):\n"
        "    sys.modules[m] = None\n"
        "import tpuflow_torch\n"
        "import tpuflow_torch.infer.serve, tpuflow_torch.infer.generate\n"
        "import tpuflow_torch.infer.quant, tpuflow_torch.models.convert\n"
        "import tpuflow_torch.models.resnet, tpuflow_torch.models.vit\n"
        "import tpuflow_torch.data.datasets, tpuflow_torch.infer.engine\n"
        "import tpuflow_torch.ops.flash_attention\n"
        "import tpuflow_torch.train.gpt, tpuflow_torch.train.step\n"
        "import tpuflow_torch.train.optim, tpuflow_torch.data.lm\n"
        "import tpuflow_torch.models.losses, tpuflow_torch.ckpt.tree\n"
        "import tpuflow_torch.ckpt.manager, tpuflow_torch.ckpt.raw\n"
        "import tpuflow_torch.flows.my_torch_module, tpuflow_torch.dist\n"
        "import tpuflow_torch.flow, tpuflow_torch.flow.runner\n"
        "import tpuflow_torch.parallel.pipeline, tpuflow_torch.parallel.p2p\n"
        "import tpuflow_torch.parallel.ring_attention\n"
        "import tpuflow_torch.parallel.ulysses\n"
        "import tpuflow_torch.flow.gang_exec, tpuflow_torch.flow.store\n"
        "import tpuflow_torch.utils.locking, tpuflow_torch.utils.preempt\n"
        "import tpuflow_torch.flows.train_flow, tpuflow_torch.flows.eval_flow\n"
        "import tpuflow_torch.flows.gpt_flow\n"
        "import tpuflow_torch.flows.gpt_eval_flow\n"
        "import tpuflow_torch.infer.beam, tpuflow_torch.infer.score\n"
        "import tpuflow_torch.infer.speculative\n"
        "import tpuflow_torch.infer.kv_store\n"
        "import tpuflow_torch.models.moe, tpuflow_torch.models.import_hf\n"
        "import tpuflow_torch.obs, tpuflow_torch.obs.recorder\n"
        "import tpuflow_torch.obs.catalog, tpuflow_torch.obs.flight\n"
        "import tpuflow_torch.obs.timeline, tpuflow_torch.testing.faults\n"
        "import tpuflow_torch.obs.health, tpuflow_torch.utils.heartbeat\n"
        "import tpuflow_torch.train.trainer, tpuflow_torch.flow.client\n"
        "import tpuflow_torch.infer.frontdoor, tpuflow_torch.obs.export\n"
        "import tpuflow_torch.obs.serve_ledger, tpuflow_torch.obs.fleet\n"
        "import tpuflow_torch.obs.goodput, tpuflow_torch.obs.trace\n"
        "import tpuflow_torch.infer.router, tpuflow_torch.testing.chaos\n"
        "import tpuflow_torch.obs.registry, tpuflow_torch.obs.alerts\n"
        "import tpuflow_torch.obs.__main__, tpuflow_torch.obs.watch\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
