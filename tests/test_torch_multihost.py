"""The port's multi-host join (karpenter_tpu_torch/parallel/multihost.py),
the counterparts of tests/test_multihost.py, on the CPU.

torch.distributed's process group is once per process, so every live
join runs in SUBPROCESSES: each binds a free localhost port for the
rendezvous, joins over gloo, and has at most 120 s. Each process brings
four virtual copies of the CPU (utils/device.force_virtual_devices), so
a joined pair's global mesh has eight entries, four per rank.

Tolerance: bitwise; a joined fleet's sharded programs (their per-shard
results exchanged with all_gather over gloo) equal one process's
single-device programs on the same inputs.

Deliberate divergences from the reference, each pinned here: the
topology comes from torch's rendezvous env (MASTER_ADDR + MASTER_PORT,
WORLD_SIZE, RANK) with no cluster auto-detection, and where the
reference's join raises after its backend initialised (torch has no such
order), the port's second join with a conflicting topology raises.
"""

from __future__ import annotations

import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def clean_env(**extra) -> dict:
    """A subprocess env with no inherited topology and no card."""
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_VARS}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def run_all(procs):
    """(rc, stdout, stderr) of each process, killing any that outlives
    the timeout (its stderr is kept for the diagnosis)."""
    outs = []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for proc in procs:
            left = max(1.0, deadline - time.monotonic())
            out, err = proc.communicate(timeout=left)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def spawn(script: str, *args, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", script, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env or clean_env(), cwd=REPO,
    )


_SINGLE = r"""
import sys
from karpenter_tpu_torch.utils.device import force_virtual_devices
force_virtual_devices(4, "cpu")
from karpenter_tpu_torch.parallel import multihost
joined = multihost.initialize_multihost(
    coordinator_address=f"localhost:{sys.argv[1]}", num_processes=1,
    process_id=0,
)
assert joined, "explicit 1-process topology must join"
assert multihost.process_count() == 1
assert len(multihost.global_devices()) == 4
assert multihost.initialize_multihost() is True  # idempotent
from karpenter_tpu_torch.parallel.mesh import dryrun_fleet_step
dryrun_fleet_step(len(multihost.global_devices()))
print("MULTIHOST-OK")
"""


def test_single_process_fleet_joins_and_solves():
    ((rc, out, err),) = run_all([spawn(_SINGLE, free_port())])
    assert rc == 0, err[-2000:]
    assert "MULTIHOST-OK" in out


_TWO = r"""
import sys
pid, port = int(sys.argv[1]), sys.argv[2]
from karpenter_tpu_torch.utils.device import force_virtual_devices
force_virtual_devices(4, "cpu")  # 4 local devices per process -> 8 global
from karpenter_tpu_torch.parallel import multihost
assert multihost.initialize_multihost(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid,
)
assert multihost.process_count() == 2
assert multihost.process_index() == pid
fleet = multihost.global_devices()
assert [r for r, _ in fleet] == [0] * 4 + [1] * 4, fleet

import numpy as np
import torch
from karpenter_tpu_torch.parallel import mesh as PM

d_in, b_in = PM.dryrun_inputs("cpu")
# the GLOBAL slice x pods x groups mesh spans both processes
mesh = PM.build_mesh(n_devices=8, slices=2)
assert mesh.multi_rank and len(mesh.local_positions()) == 4
# single-process reference over the SAME mesh-padded inputs (identical
# on both processes by construction: the same seeds)
pd_in = PM.pad_decision_inputs_for_mesh(d_in, mesh)
pb_in = PM.pad_binpack_inputs_for_mesh(b_in, mesh)
d_ref, b_ref = PM.fleet_step(pd_in, pb_in, buckets=8, device="cpu")
d_out, b_out = PM.fleet_step(PM.shard_decision_inputs(mesh, d_in),
                             PM.shard_binpack_inputs(mesh, b_in), buckets=8)
for got, want in ((b_out.assigned, b_ref.assigned),  # padding rows too
                  (b_out.assigned_count, b_ref.assigned_count),
                  (b_out.nodes_needed, b_ref.nodes_needed),
                  (b_out.lp_bound, b_ref.lp_bound),
                  (b_out.unschedulable, b_ref.unschedulable),
                  (d_out.desired, d_ref.desired)):
    assert torch.equal(got, want), (got, want)
# the row programs across ranks too
f_ref = PM.sharded_decide(PM.build_mesh(n_devices=4, devices=[
    torch.device("cpu")] * 4), d_in)
f_out = PM.sharded_decide(mesh, d_in)
assert torch.equal(f_out.desired, f_ref.desired)
# the card route's exchange across ranks (partials gathered in global
# block order, one reduction per rank), on the wrappers' plain versions
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF
wide = TB.inputs_from_numpy(workloads.build_inputs(
    pods=3000, types=40, taints=8, labels=8, seed=2), "cpu")
card = PM._card_route(PM.shard_binpack_inputs(mesh, wide), 32)
fused = TF.binpack_fused(wide, 32)
for name in ("assigned", "assigned_count", "nodes_needed", "lp_bound",
             "unschedulable"):
    assert torch.equal(getattr(card, name), getattr(fused, name)), name
PM.dryrun_fleet_step(8)
print(f"TWOPROC-OK pid={pid}")
"""


def test_two_process_fleet_joins_and_matches_single_process():
    """Two processes join over gloo, build one GLOBAL 2-slice mesh over 8
    devices split 4 + 4, run the sharded fleet step (each rank its own
    shards, results exchanged), and both equal the single-process
    program; then each runs the dry run on the global mesh."""
    port = free_port()
    outs = run_all([spawn(_TWO, pid, port) for pid in (0, 1)])
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{err[-3000:]}"
        assert f"TWOPROC-OK pid={pid}" in out


def test_two_sidecar_fleet_joins_and_serves():
    """The deployment contract: one sidecar per host, `--multihost`,
    topology from torch's rendezvous env. Two `python -m
    karpenter_tpu_torch.sidecar` processes join one fleet; the
    coordinator's Health reports the GLOBAL device count (one CPU each:
    2, where a sidecar that failed to join would say 0) and its Solve RPC
    answers as an in-process solve."""
    from karpenter_tpu_torch.ops import binpack as TB
    from karpenter_tpu_torch.parallel.mesh import example_binpack_inputs
    from karpenter_tpu_torch.sidecar.client import SolverClient

    coord, grpc0, grpc1 = free_port(), free_port(), free_port()
    procs = []
    try:
        for pid, gport in ((0, grpc0), (1, grpc1)):
            env = clean_env(MASTER_ADDR="localhost", MASTER_PORT=str(coord),
                            WORLD_SIZE="2", RANK=str(pid),
                            NO_GCE_CHECK="true")
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", "karpenter_tpu_torch.sidecar",
                 "--multihost", "--device", "cpu", "--host", "127.0.0.1",
                 "--port", str(gport)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=REPO,
            ))
        deadline = time.monotonic() + TIMEOUT_S
        banner = None
        while time.monotonic() < deadline and banner is None:
            if procs[0].poll() is not None:
                break
            ready, _, _ = select.select([procs[0].stdout], [], [], 0.5)
            if ready:
                line = procs[0].stdout.readline()
                if line:
                    banner = json.loads(line)
        assert banner and banner["serving"].endswith(str(grpc0)), (
            f"no serving banner (coordinator rc={procs[0].poll()})"
        )
        client = SolverClient(f"127.0.0.1:{grpc0}", timeout_seconds=60.0)
        try:
            ok, health = client.health()
            assert ok
            assert health["device_count"] == 2, health
            assert health["backend"] == "cpu"
            inputs = example_binpack_inputs(P_=64, T=8, device="cpu")
            remote = client.solve(inputs, buckets=8)
        finally:
            client.close()
        local = TB.solve(inputs, buckets=8, backend="numpy")
        for name in ("assigned", "assigned_count", "nodes_needed",
                     "lp_bound", "unschedulable"):
            np.testing.assert_array_equal(np.asarray(getattr(remote, name)),
                                          np.asarray(getattr(local, name)))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        run_all(procs)


def test_no_topology_is_single_host_noop(monkeypatch):
    """With no topology configured the seam reports False at once (torch
    has no cluster auto-detection) and the caller proceeds single-host;
    the process's global devices are its own."""
    import torch

    from karpenter_tpu_torch.parallel import multihost
    from karpenter_tpu_torch.utils import device as UD

    for var in TOPOLOGY_VARS:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_multihost() is False
    assert not multihost.joined() and multihost.process_count() == 1
    UD.force_virtual_devices(3, "cpu")
    try:
        assert multihost.global_devices() == [(0, torch.device("cpu"))] * 3
    finally:
        UD.reset_virtual_devices()


_CONFLICT = r"""
import sys
from karpenter_tpu_torch.parallel import multihost
port, other = sys.argv[1], sys.argv[2]
assert multihost.initialize_multihost(f"localhost:{port}", 1, 0, kind="cpu")
assert multihost.initialize_multihost(f"localhost:{port}", 1, 0) is True
try:
    multihost.initialize_multihost(f"localhost:{other}", 1, 0)
except RuntimeError as error:
    assert "conflicts" in str(error), error
    print("CONFLICT-OK")
"""


def test_conflicting_second_join_raises():
    """The counterpart of the reference's join-after-backend-init pin
    (torch has no backend whose initialization a join must precede): a
    second join with the same topology is a no-op, one with another
    topology raises, never silently keeps or swaps the fleet."""
    ((rc, out, err),) = run_all([spawn(_CONFLICT, free_port(), free_port())])
    assert rc == 0, err[-2000:]
    assert "CONFLICT-OK" in out


@pytest.mark.parametrize("env", [
    {"RANK": "3"},
    {"MASTER_ADDR": "localhost", "MASTER_PORT": "1234", "WORLD_SIZE": "2"},
    {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2", "RANK": "0"},
])
def test_partial_topology_raises(monkeypatch, env):
    """A half-configured host crashes loudly, never serves single-host
    while the rest of the fleet hangs waiting for it."""
    from karpenter_tpu_torch.parallel import multihost

    for var in TOPOLOGY_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match="partial multihost topology"):
        multihost.initialize_multihost()
