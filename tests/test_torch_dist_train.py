"""``launch.train --data-parallel`` on gloo ranks on the host (``--device
cpu``, ``--reduced``): two ranks against one process at the same global
batch, a world of one against the plain run, and two ranks resuming the
JAX package's ``--data-parallel`` run from its checkpoint.

The two-rank runs rendezvous through a ``file://`` URL under the test's
temporary directory (no TCP port to collide between test workers); a rank
that fails or hangs fails the test, and every rank is killed then."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from repro_torch.launch import train as launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1",
       "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 240
COMMON = ["--arch", "yi-9b", "--reduced", "--batch", "4", "--seq-len", "16"]

# the launcher with the arch at fp32 compute: in bf16 the gradient of a
# half batch is rounded to bf16 before the two halves are summed, so the
# ranks' sum differs from one process's by bf16 rounding (2.9e-5 and
# 1.9e-4 relative in the losses of steps 2 and 3 here); fp32 isolates what
# the data-parallel step itself does
FP32 = ("import dataclasses, sys\n"
        "from repro_torch.launch import train as t\n"
        "arch = t.get_arch\n"
        "t.get_arch = lambda name: dataclasses.replace(arch(name), "
        "compute_dtype='float32')\n"
        "t.main(sys.argv[1:])\n")


def _ranks(args, tmp, world, script=None):
    """``world`` launcher ranks with --data-parallel over gloo; every rank
    killed at the first failure or at the deadline."""
    head = ["-c", script] if script else ["-m", "repro_torch.launch.train"]
    url = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, *head, *args, "--device", "cpu", "--data-parallel",
         "--dist-init", url],
        env={**ENV, "RANK": str(r), "WORLD_SIZE": str(world)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [(p.wait(), p.stdout.read(), p.stderr.read()) for p in procs]
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    return [out for _, out, _ in outs]


def _losses(path):
    return [m["loss"] for m in json.loads(path.read_text())]


@pytest.mark.slow
def test_two_ranks_match_one_process(tmp_path):
    args = COMMON + ["--steps", "3"]
    one = tmp_path / "one.json"
    subprocess.run([sys.executable, "-c", FP32, *args, "--device", "cpu",
                    "--metrics-out", str(one)], env=ENV, check=True,
                   capture_output=True, timeout=TIMEOUT_S)
    dp = tmp_path / "dp.json"
    outs = _ranks(args + ["--metrics-out", str(dp)], tmp_path, 2, FP32)
    want, got = _losses(one), _losses(dp)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    # rank 0 alone logs
    assert "[train] done" in outs[0] and outs[1] == ""


def test_a_world_of_one_is_the_plain_run(tmp_path, capsys):
    """--data-parallel on a world of one (started plainly) takes the
    plain run's steps bit for bit, and leaves no process group behind."""
    import torch.distributed as dist

    args = COMMON + ["--steps", "2", "--device", "cpu"]
    plain = launch.main(args)
    dp = launch.main(args + ["--data-parallel"])
    assert [m["loss"] for m in dp] == [m["loss"] for m in plain]
    assert [m["grad_norm"] for m in dp] == [m["grad_norm"] for m in plain]
    assert not dist.is_initialized()


def test_a_world_of_one_sums_once_a_step(monkeypatch):
    """Where no leaf is split over the batch axes (plain --data-parallel),
    a step makes two all-reduce calls: the token count, then the loss,
    the metrics and every gradient leaf in one call after the region —
    none a leaf or a period at a time."""
    from repro_torch.dist import collectives

    calls = []
    reduce = collectives.reduce_sum_

    def counted(tensors, mesh, names):
        calls.append(len(tensors))
        reduce(tensors, mesh, names)

    monkeypatch.setattr(collectives, "reduce_sum_", counted)
    launch.main(COMMON + ["--steps", "2", "--device", "cpu",
                          "--data-parallel"])
    assert len(calls) == 4 and calls[0] == calls[2] == 1, calls
    assert calls[1] == calls[3] > 10, calls


@pytest.mark.slow
def test_resumes_the_jax_data_parallel_run(tmp_path):
    """The JAX launcher trains 8 steps with --data-parallel on its one CPU
    device, checkpointing at 5; two port ranks resume from that step-5
    checkpoint: steps 6-8 within 2e-2 relative of the JAX launcher's own
    (bf16 compute, the tolerance of the port's launcher against the JAX
    package's in ``test_torch_train_launch.py``)."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    common = COMMON + ["--steps", "8", "--checkpoint-every", "5"]
    subprocess.run([sys.executable, "-m", "repro.launch.train", *common,
                    "--data-parallel", "--checkpoint-dir", str(jdir),
                    "--metrics-out", str(tmp_path / "j.json")], env=ENV,
                   check=True, capture_output=True, timeout=TIMEOUT_S)
    pdir.mkdir()
    shutil.copytree(jdir / "step_00000005", pdir / "step_00000005")
    outs = _ranks(common + ["--checkpoint-dir", str(pdir), "--metrics-out",
                            str(tmp_path / "p.json")], tmp_path, 2)
    assert "resumed from step 5" in outs[0], outs[0][-2000:]
    want = json.loads((tmp_path / "j.json").read_text())[5:]
    got = json.loads((tmp_path / "p.json").read_text())
    assert [m["step"] for m in got] == [6, 7, 8]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 2e-2 * abs(w["loss"]), (g, w)
    assert sorted(os.listdir(pdir)) == ["step_00000005", "step_00000008"]
