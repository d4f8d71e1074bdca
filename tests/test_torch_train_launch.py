"""The port's training launcher (``python -m repro_torch.launch.train``) in
subprocesses on the host (``--device cpu``, ``--reduced``): crash and
resume, preemption, compressed gradients, the metrics document's keys, and
a checkpoint written by the JAX package's launcher resumed by the port's."""
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import train as launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1",
       "OMP_NUM_THREADS": "2"}


def _run(module, args, check=True):
    return subprocess.run([sys.executable, "-m", module] + args, env=ENV,
                          capture_output=True, text=True, timeout=300,
                          check=check)


def _port(args, check=True):
    return _run("repro_torch.launch.train", args + ["--device", "cpu"],
                check)


@pytest.mark.slow
def test_crash_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", "gemma3-1b", "--reduced", "--steps", "14",
              "--batch", "2", "--seq-len", "32",
              "--checkpoint-dir", ckpt, "--checkpoint-every", "5"]
    # the first run crashes at step 12 (after the step-10 checkpoint)
    r = _port(common + ["--fail-at-step", "12"], check=False)
    assert r.returncode == 42, r.stderr[-2000:]
    assert "INJECTED FAILURE" in r.stdout
    # the second resumes from step 10 and completes
    r2 = _port(common)
    assert "resumed from step 10" in r2.stdout, r2.stdout[-2000:]
    assert "done" in r2.stdout
    manifest = json.load(open(os.path.join(ckpt, "step_00000014",
                                           "manifest.json")))
    assert manifest["extra"] == {"data": {"step": 14}, "arch": "gemma3-1b"}
    assert "opt/.step" in manifest["keys"]


@pytest.mark.slow
def test_sigterm_checkpoints_and_exits_143(tmp_path):
    ckpt = tmp_path / "ckpt"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "yi-9b", "--reduced", "--steps", "100000", "--batch", "2",
         "--seq-len", "16", "--checkpoint-dir", str(ckpt),
         "--checkpoint-every", "100000", "--device", "cpu"],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("[train] step 1/"), line
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 143, err[-2000:]
    assert "preemption signal" in out
    steps = sorted(os.listdir(ckpt))
    assert len(steps) == 1 and steps[0].startswith("step_")
    manifest = json.load(open(ckpt / steps[0] / "manifest.json"))
    assert manifest["step"] >= 1
    assert manifest["extra"]["data"] == {"step": manifest["step"]}


@pytest.mark.slow
def test_grad_compression_training_converges(tmp_path):
    metrics = str(tmp_path / "m.json")
    _port(["--arch", "yi-9b", "--reduced", "--steps", "8", "--batch", "2",
           "--seq-len", "32", "--compress-grads", "--metrics-out", metrics])
    log = json.load(open(metrics))
    losses = [m["loss"] for m in log]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_resumes_a_jax_checkpoint_and_matches_its_metrics(tmp_path):
    """The JAX launcher trains 8 steps, checkpointing at 5; the port's
    resumes from that step-5 checkpoint: its steps 6-8 losses within 2e-2
    relative of the JAX launcher's own (bf16 compute, the reduced configs'
    default), and its metrics document has the reference's keys."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    common = ["--arch", "yi-9b", "--reduced", "--steps", "8", "--batch",
              "2", "--seq-len", "32", "--checkpoint-every", "5"]
    _run("repro.launch.train", common + ["--checkpoint-dir", str(jdir),
                                         "--metrics-out",
                                         str(tmp_path / "j.json")])
    pdir.mkdir()
    shutil.copytree(jdir / "step_00000005", pdir / "step_00000005")
    r = _port(common + ["--checkpoint-dir", str(pdir), "--metrics-out",
                        str(tmp_path / "p.json")])
    assert "resumed from step 5" in r.stdout, r.stdout[-2000:]
    want = json.load(open(tmp_path / "j.json"))
    got = json.load(open(tmp_path / "p.json"))
    assert [m["step"] for m in got] == [6, 7, 8]
    assert [sorted(m) for m in got] == [sorted(m) for m in want[5:]]
    for g, w in zip(got, want[5:]):
        assert abs(g["loss"] - w["loss"]) <= 2e-2 * abs(w["loss"]), (g, w)


def test_straggler_monitor():
    mon = launch.StragglerMonitor(factor=3.0)
    flags = [mon.record(t) for t in (1.0, 1.0, 1.1, 0.9, 1.0, 1.0, 5.0, 1.0)]
    assert flags == [False] * 6 + [True, False]
    assert mon.slow_steps == 1
