"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names; the plain reference imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_portbench_forbidden_names_are_whole_top_levels():
    assert harness.forbidden_modules({"vibevoice_tpu_torch", "vibevoice_tpu_torch.ops"}) == []
    assert harness.forbidden_modules({"jax", "jaxlib.xla", "flax", "vibevoice_tpu.models",
                                      "jaxtyping"}) == ["flax", "jax", "jaxlib.xla",
                                                        "vibevoice_tpu.models"]


def test_portbench_a_run_loads_no_jax():
    """A whole run of the tiny cell on the CPU, in a fresh process."""
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench.tests.conftest import run_tiny\n"
            "from portbench import harness, control\n"
            "import portbench.check, portbench.work, portbench.reference.model\n"
            "run_tiny(seconds=0.2)\n"
            "for m in harness.benchmark()['per_layer']: harness.reader(m['name'])\n"
            "print(json.dumps(sorted(sys.modules)))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vibevoice_tpu_torch" in mods  # the port ran
    assert harness.forbidden_modules(mods) == []


def test_portbench_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("vibevoice_tpu_torch", "vibevoice_tpu", "jax"), \
                    f"{f} imports {n}"
                if isinstance(node, ast.ImportFrom):
                    assert node.level <= 1, f"{f} imports from outside the reference"
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import portbench.reference.model, portbench.check, portbench.weights\n"
            "print(json.dumps(sorted(sys.modules)))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in mods if m.split(".")[0] in ("vibevoice_tpu_torch", "vibevoice_tpu",
                                                          "jax")]
