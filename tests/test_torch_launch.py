"""``python -m paddle_tpu_torch.distributed.launch`` against the JAX
package's launcher.

Both launchers start the same worker script (``dist_workers/launch_env.py``,
which imports neither package) with ``--nproc_per_node 2``: the PADDLE_*
variables are equal, and the port's workers also get ``torch.distributed``'s
``MASTER_ADDR`` / ``MASTER_PORT`` (a rendezvous port of their own, not the
launcher's store), ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, as
``distributed.env`` reads them. A worker that fails is restarted up to
``--max_restart`` times, then the launcher gives up with its exit code.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "dist_workers")


def _launch(pkg, tmp, script, *args, extra=()):
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("PADDLE_MASTER", "PADDLE_NNODES", "PADDLE_NODE_RANK",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", str(tmp / "log"), *extra,
         os.path.join(WORKERS, script), *args],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=120)


def _env_run(pkg, tmp):
    tmp.mkdir()
    res = _launch(pkg, tmp, "launch_env.py", str(tmp))
    assert res.returncode == 0, res.stderr[-2000:]
    return [json.load(open(tmp / f"res{r}.json")) for r in range(2)]


@pytest.fixture(scope="module")
def env_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    return {pkg: _env_run(pkg, tmp / pkg)
            for pkg in ("paddle_tpu", "paddle_tpu_torch")}


def test_launch_env_equal_to_the_jax_launcher(env_runs):
    for jr, pr in zip(env_runs["paddle_tpu"], env_runs["paddle_tpu_torch"]):
        for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                  "PADDLE_LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR"):
            assert pr[k] == jr[k], k
    assert [r["PADDLE_TRAINER_ID"] for r in env_runs["paddle_tpu_torch"]] \
        == ["0", "1"]


def test_launch_sets_the_torch_distributed_rendezvous(env_runs):
    ranks = env_runs["paddle_tpu_torch"]
    assert {r["WORLD_SIZE"] for r in ranks} == {"2"}
    assert len({r["MASTER_PORT"] for r in ranks}) == 1
    assert ranks[0]["MASTER_ADDR"] == "127.0.0.1"
    assert int(ranks[0]["MASTER_PORT"]) > 0


def test_launch_gives_up_after_max_restart(tmp_path):
    """A worker that always exits 3: restarted once, then the launcher
    stops the pod and returns 3, as the JAX launcher."""
    got = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        res = _launch(pkg, d, "launch_exit3.py", extra=("--max_restart",
                                                        "1"))
        got[pkg] = (res.returncode, res.stderr.count("restart 1/1"),
                    "failed permanently" in res.stderr)
    assert got["paddle_tpu_torch"] == got["paddle_tpu"] == (3, 1, True)
