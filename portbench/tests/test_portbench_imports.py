"""Nothing the benchmark runs loads JAX or the JAX package, and nothing in
it reads the JAX package's benchmark or its results."""

import os
import re
import subprocess
import sys

from portbench import harness

IMPORT_ALL = r'''
import glob, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "portbench"))
import run
import limits
from portbench import harness
for sub in ("drivers", "layer_metrics", "end_to_end"):
    for path in sorted(glob.glob(os.path.join(root, "portbench", sub, "*.py"))):
        harness.load_module(path, "check_" + os.path.basename(path)[:-3].replace(".", "_"))
import portbench.reference.hover_ppo, portbench.reference.landing_ppo
import portbench.counts.hover, portbench.counts.landing, portbench.trace, portbench.compare
for cell in [w["name"] for w in harness.benchmark()["workloads"]]:
    harness.find_cell(cell)
print("\n".join(sorted(sys.modules)))
'''


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL, harness.ROOT], capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr
    modules = proc.stdout.split()
    assert "torch" in modules and "portbench.harness" in modules
    assert harness.forbidden_modules(modules) == []
    # whole top-level names: the port's own name begins with the JAX package's
    assert harness.forbidden_modules(["autonomous_quadrotor_environment_tpu_torch.ops"]) == []
    assert harness.forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax.numpy"]


def test_the_sources_read_no_jax_benchmark():
    pattern = re.compile(r"bench\.py|BENCH_[A-Za-z0-9_]*\.json|MULTICHIP_|BASELINE\.json|"
                         r"__graft_entry__|^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b",
                         re.MULTILINE)
    here = os.path.join(harness.ROOT, "portbench")
    for dirpath, _, files in os.walk(here):
        if os.path.basename(dirpath) == "tests":
            continue
        for name in files:
            if name.endswith((".py", ".json")):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), os.path.join(dirpath, name)
