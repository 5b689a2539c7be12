"""The training launcher's ``--devices N`` on the CPU: ``python -m
repro_torch.launch.train --device cpu --devices 4 --preset smoke`` for a
dense LM (olmo-1b), a recsys model (dlrm-mlperf) and the GNN
(meshgraphnet), run in this process (its four gloo ranks are spawned).

Each run must print the reference's mesh line for four devices
(``{'data': 4, 'model': 1}``) and its done line, log finite losses, write
the mesh and every rank's entry into ``--metrics-json``, and resume from
its checkpoint directory: a second run with more steps prints
``[fit] resumed from step 3`` and trains on. The sharded step-0 loss
equals the one-device launcher's (same seed, same batch) to rtol 1e-5.
"""

from __future__ import annotations

import json
import math
import re

import pytest

from repro_torch.launch import train as train_cli

MESH_LINE = "[train] mesh: {'data': 4, 'model': 1}"
LOSS = re.compile(r"\[fit\] step (\d+): loss=(\S+) gnorm=(\S+)")


def _run(capfd, argv: list[str]) -> str:
    train_cli.main(["--device", "cpu", "--preset", "smoke", *argv])
    return capfd.readouterr().out


def test_mesh_shape_is_the_references():
    assert [train_cli.mesh_shape(n) for n in (2, 4, 8, 16)] == [
        (2, 1), (4, 1), (4, 2), (8, 2)]


@pytest.mark.parametrize("arch", ["olmo-1b", "dlrm-mlperf", "meshgraphnet"])
def test_devices_4_trains_and_resumes(arch, tmp_path, capfd):
    ckpt, metrics = str(tmp_path / "ckpt"), tmp_path / "m.json"
    out = _run(capfd, ["--arch", arch, "--devices", "4", "--steps", "4",
                       "--ckpt-dir", ckpt, "--metrics-json", str(metrics)])
    lines = out.splitlines()
    assert lines[0] == MESH_LINE, out
    steps = [(int(m[1]), float(m[2]), float(m[3]))
             for m in LOSS.finditer(out)]
    assert [s for s, _, _ in steps] == [0, 1, 2, 3], out
    assert all(math.isfinite(v) for _, l, g in steps for v in (l, g))
    assert re.search(r"\[train\] done: loss \S+ -> \S+ over 4 steps", out)
    m = json.loads(metrics.read_text())
    assert m["mesh"] == {"data": 4, "model": 1}
    assert m["backend"] == "gloo"
    assert [r["rank"] for r in m["ranks"]] == [0, 1, 2, 3]
    assert [h["step"] for h in m["history"]] == [0, 1, 2, 3]

    again = _run(capfd, ["--arch", arch, "--devices", "4", "--steps", "6",
                         "--ckpt-dir", ckpt])
    assert "[fit] resumed from step 3" in again, again
    assert [int(m[1]) for m in LOSS.finditer(again)] == [4, 5], again
    assert re.search(r"over 6 steps", again)

    one = _run(capfd, ["--arch", arch, "--steps", "1"])
    (first,) = [float(m[2]) for m in LOSS.finditer(one)]
    assert first == pytest.approx(steps[0][1], rel=1e-5)
