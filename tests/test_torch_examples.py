"""The port's examples (``repro_torch.examples``) at small sizes on the CPU,
each run in a temporary working directory (they write under
``results/torch/``), against the JAX package's where the output is
deterministic:

  * ``schedule_dag``: the placement and the predicted schedule equal what
    the JAX package compiles from the same trace over its own simulated
    devices (the JAX example itself stops at its last assert, which holds
    a traced ``KernelTask`` equal to a hand-built one without its
    ``out_bytes`` and ``input_deps``);
  * ``program_compile``: the exported Program JSON equals the JAX
    example's ``author`` program's;
  * ``serve_blur_pipeline``: the request stream equals the reference's
    draws, and its schedule equals the JAX scheduler's under the same
    predictions.

The examples that take a device run with ``--device cpu``; without it they
need a card.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:            # the JAX package's examples
    sys.path.insert(0, str(ROOT))

import repro.api as japi  # noqa: E402  (before repro.workloads: import cycle)
from repro.api import export as jexport  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.runtime import default_registry as jdefault_registry  # noqa: E402
from repro.runtime.simdev import fake_matmul_device as jfake  # noqa: E402
from examples import program_compile as jprogram_compile  # noqa: E402
from repro_torch.api import export  # noqa: E402
from repro_torch.autotune import tuner  # noqa: E402
from repro_torch.examples import (async_pipeline, autotune_attention,  # noqa: E402
                                  program_compile, quickstart,
                                  runtime_dispatch, schedule_dag,
                                  serve_blur_pipeline, train_100m)
from repro_torch.runtime import default_registry  # noqa: E402

SIM = {"cpu": "sim-cpu", "gpu": "sim-gpu"}   # the JAX example's names


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_schedule_dag_placement_equals_jax(tmp_path):
    got = schedule_dag.main()
    reg = jdefault_registry(include=["matmul"])
    devices = {"cpu": jfake(str(tmp_path / "j"), "cpu-xeon", 1e9, reg),
               "gpu": jfake(str(tmp_path / "j"), "gpu-tesla", 1e11, reg)}
    rng = np.random.RandomState(0)
    arrs = [rng.rand(*s).astype(np.float32)
            for s in ((100, 100), (100, 100), (1024, 1024), (1024, 1024))]
    with japi.trace(registry=reg) as tb:
        small = japi.ops.matmul(arrs[0], arrs[1])
        big = japi.ops.matmul(arrs[2], arrs[3])
    compiled = tb.compile(devices=devices)
    assert got["placement"] == {small.name: "sim-cpu", big.name: "sim-gpu"}
    assert got["placement"] == {n.name: SIM[compiled.device_of(n.name)]
                                for n in (small, big)}
    want = compiled.gantt()
    assert [(r["task"], r["device"]) for r in got["gantt"]] == \
        [(r["task"], SIM[r["device"]]) for r in want]
    for g, w in zip(got["gantt"], want):
        assert g["finish_s"] == pytest.approx(w["finish_s"], rel=1e-6)
    assert json.loads(Path(schedule_dag.OUT).read_text())["placement"] \
        == got["placement"]


def test_program_compile_json_equals_jax():
    got = export.program_to_json(
        program_compile.author(default_registry(include=["matmul"])))
    want = jexport.program_to_json(
        jprogram_compile.author(jdefault_registry(include=["matmul"])))
    assert got == want
    res = program_compile.main()
    assert res["err"] < 1e-5
    assert json.loads(Path(program_compile.PROGRAM_JSON).read_text()) == got
    assert Path(program_compile.GANTT_CSV).read_text().startswith("task,")


def test_serve_blur_requests_and_schedule_equal_jax(monkeypatch):
    monkeypatch.setattr(serve_blur_pipeline, "EPOCHS", 300)
    predict = serve_blur_pipeline.fit_predictor()
    tasks = serve_blur_pipeline.requests(np.random.RandomState(0))
    rng = np.random.RandomState(0)      # the reference's loop, verbatim
    jtasks = []
    for i in range(12):
        m_dim = int(rng.choice([128, 256, 512, 1024]))
        jtasks.append(jscheduler.KernelTask(
            f"req{i:02d}", "mc",
            {"m": m_dim, "n": m_dim, "r": int(rng.choice([3, 5, 7])),
             "d": 1.0}))
    assert [(t.name, t.params) for t in tasks] == \
        [(t.name, t.params) for t in jtasks]
    devices = list(serve_blur_pipeline.DEVICES)
    from repro_torch.core.scheduler import schedule
    got = schedule(tasks, predict, devices)
    want = jscheduler.schedule(jtasks, predict, devices)
    assert {n: (a.device, a.start, a.finish) for n, a in got.items()} == \
        {n: (a.device, a.start, a.finish) for n, a in want.items()}
    res = serve_blur_pipeline.main()
    assert set(res["schedule"]) == {t.name for t in tasks}
    assert res["makespan_s"] <= min(res["single_s"].values())


def test_async_pipeline_equal_and_traced(monkeypatch):
    monkeypatch.setattr(async_pipeline, "N", 64)
    res = async_pipeline.main()
    assert res["async_wall_s"] > 0 and res["seq_wall_s"] > 0
    doc = json.loads(Path(async_pipeline.TRACE_JSON).read_text())
    assert doc["traceEvents"]


def test_quickstart_on_the_cpu(monkeypatch):
    monkeypatch.setattr(quickstart, "NNC_EPOCHS", 300)
    monkeypatch.setattr(quickstart, "LM_STEPS", 2)
    res = quickstart.main(["--device", "cpu"])
    assert res["api"]["err"] < 1e-4
    assert {k for k, _, _ in res["api"]["picks"]} <= {"matmul", "blur"}
    assert res["nnc"]["n_params"] <= 75 and np.isfinite(res["nnc"]["mape"])
    assert all(np.isfinite(res["lm"]["losses"]))


def test_runtime_dispatch_cold_warm_reload(monkeypatch):
    monkeypatch.setattr(runtime_dispatch, "SHAPES",
                        [(64, 64), (96, 64), (128, 96)])
    monkeypatch.setattr(runtime_dispatch, "WARM_REPS", 2)
    res = runtime_dispatch.main(["--device", "cpu"])
    assert res["child"]["measured"] == 0
    assert res["child"]["selections"] == res["warm"]
    assert set(res["cold"]) == {"64x64", "96x64", "128x96"}


def test_autotune_attention_on_the_cpu(monkeypatch):
    monkeypatch.setattr(autotune_attention, "TRAIN_SHAPES",
                        [(1, 2, 256, 32), (1, 2, 512, 32)])
    monkeypatch.setattr(autotune_attention, "TEST_SHAPE", (1, 2, 512, 32))
    monkeypatch.setattr(autotune_attention, "SCHEDULES",
                        [(128, 256), (256, 256), (128, 512)])
    monkeypatch.setattr(autotune_attention, "DEFAULT", (256, 256))
    real = tuner.MLPModel
    monkeypatch.setattr(tuner, "MLPModel",
                        lambda layers, epochs: real(layers, epochs=300))
    res = autotune_attention.main(["--device", "cpu"])
    assert tuple(res["chosen"]) in autotune_attention.SCHEDULES
    assert res["regret"] >= 1.0 and res["n_params"] <= 75


def test_train_100m_config_and_a_small_run(monkeypatch):
    from repro.models import build_model as jbuild
    from repro.models import module as jmodule
    from repro_torch.models import build_model, module
    sys.path.insert(0, str(ROOT / "examples"))
    import train_100m as jtrain_100m
    sys.path.remove(str(ROOT / "examples"))
    cfg = train_100m.model_100m()
    want = jtrain_100m.model_100m()
    assert module.count_params(build_model(cfg).param_specs()) == \
        jmodule.count_params(jbuild(want).param_specs())
    assert cfg.name == want.name == "yi-100m"
    small = dataclasses.replace(cfg.reduced(), name="yi-100m")
    monkeypatch.setattr(train_100m, "model_100m", lambda: small)
    log = train_100m.main(["--steps", "2", "--batch", "2", "--seq-len",
                           "16", "--device", "cpu"])
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    assert json.loads(Path(train_100m.METRICS).read_text()) == log
    assert (Path("results/torch/train_100m_ckpt") / "step_00000002").is_dir()


@pytest.mark.parametrize("example", [quickstart, runtime_dispatch,
                                     autotune_attention, train_100m])
def test_device_examples_need_a_card_by_default(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if example is train_100m:
        monkeypatch.setattr(train_100m, "model_100m", lambda: dataclasses
                            .replace(train_100m.get_arch("yi-9b").reduced(),
                                     name="yi-100m"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        example.main([])
