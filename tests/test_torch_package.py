"""repro_torch as a package (``traceio``, ``analysis``, ``serving``,
``ckpt`` and ``faults`` included): it imports neither JAX nor the JAX
package, its entry points refuse to run without CUDA unless asked for the
CPU, the launchers run on the CPU (the train launcher resuming from its
``--ckpt-dir``), and the kernel build keys, logs and reports.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_every_module_loads_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 33, names
        assert {"repro_torch.train.loop", "repro_torch.optim.adamw",
                "repro_torch.kernels.fused_adam", "repro_torch.kernels.dgc_topk",
                "repro_torch.data.pipeline", "repro_torch.runtime.fault",
                "repro_torch.launch.train"} <= set(names), names
        assert {f"repro_torch.traceio.{m}" for m in (
                    "events", "align", "chrome", "importer", "synthetic", "xla",
                    "torch_profiler")} | {f"repro_torch.analysis.{m}" for m in (
                    "critical_path", "diff", "opportunity", "calibrate")} \
            <= set(names), names
        assert {f"repro_torch.serving.{m}" for m in (
                    "workload", "costs", "graphgen", "scenario", "measure")} | {
                "repro_torch.serving", "repro_torch.configs.serving",
                "repro_torch.configs.llama3_2_1b", "repro_torch.configs.llama3_405b",
                "repro_torch.launch.serve_sim"} <= set(names), names
        assert {f"repro_torch.faults.{m}" for m in (
                    "events", "recovery", "goodput", "scenario")} | {
                "repro_torch.faults", "repro_torch.ckpt",
                "repro_torch.ckpt.checkpoint", "repro_torch.convert",
                "repro_torch.launch.goodput",
                "repro_torch.launch.perf_report"} <= set(names), names
        assert {f"repro_torch.launch.{m}" for m in (
                    "calibrate", "diagnose", "hillclimb")} | {
                "repro_torch.core.calibrate"} <= set(names), names
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 33
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_no_source_imports_triton():
    """Every kernel of the port is CUDA C++ built by nvcc: no module of the
    package imports Triton."""
    for path in sorted(PORT.rglob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] != "triton", (path, mod)
    ast_imports = {mod for path in PORT.rglob("*.py") for mod in _imports(path)}
    assert "torch" in ast_imports


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--smoke"])


def test_train_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke"])
    Trainer(cfg, TrainerConfig(), device="cpu")


def test_train_launcher_trains_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` as a user
    runs it: a few steps, the loss printed, the metrics written."""
    out = tmp_path / "metrics.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device",
         "cpu", "--steps", "4", "--batch", "2", "--seq", "16", "--log-every", "2",
         "--metrics-out", str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "step      0 loss=" in run.stdout and "step      2 loss=" in run.stdout
    assert "over 4 steps (device=cpu)" in run.stdout
    metrics = json.loads(out.read_text())
    assert [m["step"] for m in metrics] == [0, 1, 2, 3]
    assert all(m["loss"] > 0 and m["grad_norm"] > 0 for m in metrics)


def test_train_launcher_resumes_from_ckpt_dir(tmp_path):
    """``--ckpt-dir``: a run of 4 steps checkpoints its last step, and a
    run to 6 on the same directory trains steps 4 and 5 only."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ckpt = tmp_path / "ckpt"
    steps = []
    for n in (4, 6):
        out = tmp_path / f"metrics{n}.json"
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--device", "cpu", "--steps", str(n), "--batch", "2", "--seq", "16",
             "--log-every", "0", "--ckpt-dir", str(ckpt), "--metrics-out",
             str(out)], env=env, cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
        assert run.returncode == 0, run.stdout + run.stderr
        steps.append([m["step"] for m in json.loads(out.read_text())])
    assert steps == [[0, 1, 2, 3], [4, 5]]
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000005"]
    manifest = json.loads((ckpt / "step_00000005" / "manifest.json").read_text())
    assert manifest["step"] == 5 and "params.blocks.attn.wq" in manifest["leaves"]


def test_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--max-new", "4", "--max-seq", "16"])
    out = capsys.readouterr().out
    assert "generated 8 tokens" in out and "tok/s" in out
    assert "prefill" in out and "ms/token (3 steps)" in out


def _fake_nvcc(bin_dir: Path, exit_code: int) -> None:
    """An ``nvcc`` that writes its ``-o`` file and a ptxas-like report."""
    bin_dir.mkdir()
    script = bin_dir / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        out = sys.argv[sys.argv.index("-o") + 1]
        print("ptxas info    : Used 7 registers", " ".join(sys.argv[1:]))
        if {exit_code}:
            sys.exit({exit_code})
        open(out, "w").write("lib")
    """))
    script.chmod(0o755)


@pytest.mark.parametrize("exit_code", [0, 1])
def test_build_runs_nvcc_per_source_and_keys_by_hash(tmp_path, monkeypatch,
                                                     exit_code):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    _fake_nvcc(tmp_path / "bin", exit_code)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    if exit_code:
        with pytest.raises(RuntimeError, match="nvcc failed for a.cu"):
            _build.build_all()
        assert not list(build.glob("*.so"))
        return
    libs = _build.build_all()
    assert sorted(libs) == ["a", "b"] and all(p.exists() for p in libs.values())
    log = libs["a"].with_suffix(".log").read_text()
    assert "Used 7 registers" in log and "arch=compute_90a,code=sm_90a" in log
    (csrc / "a.cu").write_text("// a, edited\n")
    again = _build.build_all()
    assert again["a"] != libs["a"] and again["b"] == libs["b"]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "no" / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
