"""The port stands alone: nothing under src/repro_torch/ or tools/, and not
chip_smoke.py, imports jax or any module of the JAX package ``repro``."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("kernels/__init__.py", "kernels/matmul/ops.py",
                   "kernels/matvec/ops.py", "kernels/conv2d/ops.py",
                   "kernels/maxpool/ops.py", "kernels/blur/ops.py",
                   "core/features.py", "core/nnc.py",
                   "runtime/dispatch.py", "api/compile_.py",
                   "workloads/library.py", "kernels/blur/blur.py",
                   "exec/__init__.py", "exec/trace.py", "exec/buffers.py",
                   "exec/comm.py", "exec/executor.py", "runtime/simdev.py",
                   "bench/harness.py", "bench/schema.py", "obs/report.py",
                   "obs/dashboard.py", "core/selection.py",
                   "perfdata/simulate.py", "perfdata/datasets.py",
                   "perfdata/measure.py", "paper/__init__.py",
                   "paper/__main__.py", "paper/tables.py",
                   "paper/unconstrained.py", "paper/omitted_kernels.py",
                   "paper/variant_selection.py",
                   "paper/runtime_overhead.py",
                   "paper/executor_overlap.py", "configs/__init__.py",
                   "configs/base.py", "configs/gemma3_1b.py",
                   "configs/yi_9b.py", "dist/__init__.py",
                   "dist/sharding.py", "models/__init__.py",
                   "models/module.py", "models/layers.py",
                   "models/attention.py", "models/ssm.py",
                   "models/xlstm.py", "models/moe.py",
                   "models/transformer.py", "models/registry.py",
                   "serve/__init__.py", "serve/policy.py",
                   "serve/continuous.py", "serve/request.py",
                   "serve/decode.py", "serve/engine.py",
                   "bench/serve_trace.py", "checkpoint/__init__.py",
                   "checkpoint/manager.py", "launch/__init__.py",
                   "launch/serve.py", "data/__init__.py",
                   "data/pipeline.py", "optim/__init__.py",
                   "optim/adamw.py", "optim/schedules.py",
                   "optim/compression.py", "train/__init__.py",
                   "train/step.py", "launch/train.py",
                   "launch/mesh.py", "launch/hlo_analysis.py",
                   "launch/roofline.py", "launch/dryrun.py",
                   "launch/profile.py", "autotune/__init__.py",
                   "autotune/tuner.py", "paper/roofline.py",
                   "paper/kernel_projection.py", "examples/__init__.py",
                   "examples/quickstart.py", "examples/schedule_dag.py",
                   "examples/program_compile.py",
                   "examples/async_pipeline.py",
                   "examples/serve_blur_pipeline.py",
                   "examples/runtime_dispatch.py",
                   "examples/autotune_attention.py",
                   "examples/train_100m.py"):
        assert f"src/repro_torch/{module}" in names


# the port's multi-process tests: each holds the port's dist layer to the
# JAX package, imported or run (only tests reach both)
DIST_TESTS = ("test_torch_dist.py", "test_torch_dist_train.py",
              "test_torch_dist_blocked.py", "test_torch_dist_tp.py",
              "test_torch_dist_tp_recurrent.py", "test_torch_remat.py",
              "test_torch_dist_value_rows.py")


@pytest.mark.parametrize("name", DIST_TESTS)
def test_dist_tests_hold_the_port_to_the_reference(name):
    text = (ROOT / "tests" / name).read_text()
    assert re.search(r"\brepro\.", text) and "repro_torch." in text


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path}: forbidden imports {bad}"


def _import_in_subprocess(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_importing_the_port_loads_no_jax():
    out = _import_in_subprocess(
        "import sys\n"
        "import repro_torch.api, repro_torch.runtime, repro_torch.workloads\n"
        "import repro_torch.exec, repro_torch.runtime.simdev\n"
        "import repro_torch.bench, repro_torch.obs\n"
        "import repro_torch.paper.__main__, repro_torch.paper.tables\n"
        "import repro_torch.paper.unconstrained, "
        "repro_torch.paper.omitted_kernels\n"
        "import repro_torch.paper.variant_selection, "
        "repro_torch.paper.runtime_overhead\n"
        "import repro_torch.paper.executor_overlap\n"
        "import repro_torch.configs, repro_torch.dist, repro_torch.models\n"
        "import repro_torch.models.moe, repro_torch.models.ssm, "
        "repro_torch.models.xlstm\n"
        "import repro_torch.serve, repro_torch.bench.serve_trace\n"
        "import repro_torch.checkpoint, repro_torch.launch.serve\n"
        "import repro_torch.data.pipeline, repro_torch.optim\n"
        "import repro_torch.optim.compression, repro_torch.train.step\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.dist.compat, repro_torch.dist.collectives\n"
        "import repro_torch.dist.ring_attention\n"
        "import repro_torch.launch.mesh, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.profile, repro_torch.autotune.tuner\n"
        "import repro_torch.paper.roofline, "
        "repro_torch.paper.kernel_projection\n"
        "import repro_torch.examples.quickstart, "
        "repro_torch.examples.schedule_dag\n"
        "import repro_torch.examples.program_compile, "
        "repro_torch.examples.async_pipeline\n"
        "import repro_torch.examples.serve_blur_pipeline, "
        "repro_torch.examples.runtime_dispatch\n"
        "import repro_torch.examples.autotune_attention, "
        "repro_torch.examples.train_100m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    assert out.strip() == "[]"


def test_workloads_import_without_the_compiler():
    out = _import_in_subprocess(
        "import sys\n"
        "import repro_torch.workloads\n"
        "print('repro_torch.api.compile_' in sys.modules)\n"
        "from repro_torch.api import compile_program\n"
        "print('repro_torch.api.compile_' in sys.modules)\n")
    assert out.split() == ["False", "True"]
