"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` pulls in no JAX and no ``repro`` module."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
# the training, serving and recsys slices' modules are among them
assert {"repro_torch.optim.adamw", "repro_torch.optim.grad_compress", "repro_torch.train.step",
        "repro_torch.tree", "repro_torch.bench.gnn_train", "repro_torch.models.transformer",
        "repro_torch.serve.engine", "repro_torch.data.tokens",
        "repro_torch.bench.serve", "repro_torch.models.recsys", "repro_torch.data.recsys",
        "repro_torch.configs.autoint", "repro_torch.configs.graph500",
        "repro_torch.train.checkpoint", "repro_torch.train.fault", "repro_torch.launch.train",
        "repro_torch.bench.recsys", "repro_torch.launch.dryrun"} <= set(names), names
"""


def test_port_imports_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run here, where no card is present, or from a directory that holds
    only the script: a non-zero exit and no result line."""
    env = {**os.environ, "PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    script = os.path.join(ROOT, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(script).read())
    for path in (script, str(alone)):
        proc = subprocess.run([sys.executable, path], cwd=os.path.dirname(path), env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
