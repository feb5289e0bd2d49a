"""The sharded launcher: ``torchrun -m repro_torch.launch.serve --mesh
DATA,MODEL`` on the CPU (gloo), and ``launch/mesh.py``'s parser and its
errors against the reference's.

``torchrun --standalone`` picks a free rendezvous port, so test files
that run at once never collide.
"""

import os
import re
import subprocess
import sys

import pytest

from repro.launch.mesh import parse_serve_mesh as ref_parse_serve_mesh
from repro_torch.launch.mesh import make_serve_mesh, parse_serve_mesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SERVE = ["-m", "repro_torch.launch.serve", "--arch", "smollm_135m",
         "--reduced", "--device", "cpu", "--kv-quant"]


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _torchrun(n, extra):
    return _run(["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(n)] + SERVE + extra)


def _streams(stdout):
    """``req N [reason] ttft=…: [tokens]`` lines without their times."""
    return [re.sub(r" ttft=\S+", "", line) for line in stdout.splitlines()
            if line.startswith("req ")]


_SINGLE = {}


def _single():
    if "out" not in _SINGLE:
        out = _run(SERVE)
        assert out.returncode == 0, out.stderr
        _SINGLE["out"] = out.stdout
    return _SINGLE["out"]


@pytest.mark.parametrize("mesh", ["2,2", "1,2"])
def test_torchrun_serves_on_a_cpu_mesh(mesh):
    """Four (two) ranks under gloo: only rank 0 prints, the reference's
    ``mesh:`` line is there, and the streams are the single-device
    launcher's."""
    d, m = (int(x) for x in mesh.split(","))
    out = _torchrun(d * m, ["--mesh", mesh])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert f"mesh: data={d} model={m} heads_sharded={m > 1} " \
        f"slots/shard={4 // d}" in lines
    assert sum(line.startswith("served ") for line in lines) == 1
    assert _streams(out.stdout) == _streams(_single())
    assert len(_streams(out.stdout)) == 6


def test_torchrun_world_size_must_be_data_times_model():
    """Two ranks for a (2, 2) mesh: the launcher exits with the error,
    naming torchrun."""
    out = _torchrun(2, ["--mesh", "2,2"])
    assert out.returncode != 0
    assert "mesh (2, 2) needs 4 processes, have 2" in out.stderr
    assert "torchrun --nproc-per-node 4" in out.stderr


@pytest.mark.parametrize("spec", ["2", "a,b", "1,2,3", "", "0,1", "2,-1",
                                  "1,0"])
def test_parse_serve_mesh_errors_equal_reference(spec):
    with pytest.raises(ValueError) as ref:
        ref_parse_serve_mesh(spec)
    with pytest.raises(ValueError) as mine:
        parse_serve_mesh(spec, device="cpu")
    assert str(mine.value) == str(ref.value)


def test_mesh_without_processes_raises():
    """Outside a process group only the (1, 1) mesh can be built; any other
    shape names the launcher that starts its processes."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_serve_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="axes must be positive"):
        make_serve_mesh(0, 1, device="cpu")
