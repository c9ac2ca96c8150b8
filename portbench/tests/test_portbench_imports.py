"""What a run loads: no module of JAX or of the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
nothing of the program in the plain reference."""

import ast
import json
import os
import subprocess
import sys

from portbench.run import FORBIDDEN, HERE, ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    code = PROBE.format(root=ROOT, body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    top = loaded("import portbench.reference.models, portbench.reference.ops, "
                 "portbench.reference.train, portbench.weights, portbench.gen, "
                 "portbench.check, portbench.work.counts\n"
                 "from portbench.weights import seeded_state_dict\n"
                 "seeded_state_dict({'type': 'pose_hrnet', 'name': 'w32', 'num_joints': 17}, 1, "
                 "'cpu', input_hw=(64, 64), calib_images=1)")
    assert "simple_pose_torch" not in top
    assert not top & set(FORBIDDEN)


def test_a_run_loads_the_port_and_no_jax():
    top = loaded("from portbench.tests.small import small_cell, args\n"
                 "from portbench.run import run_cell\n"
                 "run_cell(small_cell('resnet50_dconv_se.serve_b128', batch=2), args(), "
                 "device='cpu')\n"
                 "run_cell(small_cell('hrnet_w32.train_b128', batch=2), args(), device='cpu')")
    assert "simple_pose_torch" in top and "simple_pose_tpu" not in top
    assert not top & set(FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_harness_names_jax_chip_smoke_bench_or_scripts():
    banned = set(FORBIDDEN) | {"chip_smoke", "bench", "scripts"}
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & banned, (path, tops & banned)
                if os.sep + "reference" + os.sep in path:
                    assert "simple_pose_torch" not in tops, path
