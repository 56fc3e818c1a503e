"""The port stands on PyTorch alone: no module of mind_tpu_torch, and not
chip_smoke.py, imports jax, flax, orbax or the JAX package mind_tpu, at top
level or inside a function; nor pandas, pyarrow, matplotlib, mpl_toolkits,
PIL or cv2, which the card's machine lacks (the port reads parquet, draws
and encodes frames with numpy and zlib). One case per file and ban, so each
counts."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "mind_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "flax", "orbax", "mind_tpu")
NOT_ON_THE_CARD = ("pandas", "pyarrow", "matplotlib", "mpl_toolkits", "PIL", "cv2")


def imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                node.func, "attr", "")) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for lineno, name in imported_names(tree):
        assert name.split(".")[0] not in BANNED, f"{path}:{lineno} imports {name}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_the_card_lacks(path):
    tree = ast.parse(path.read_text(), str(path))
    for lineno, name in imported_names(tree):
        assert name.split(".")[0] not in NOT_ON_THE_CARD, f"{path}:{lineno} imports {name}"


def test_every_port_module_is_covered():
    assert len(FILES) >= 80
    covered = {str(p.relative_to(ROOT / "mind_tpu_torch")) for p in FILES[:-1]}
    assert covered >= {
        "ops/fusion_attention.py", "planner/planner.py", "planner/trajectory_tree.py",
        "common/bbox.py", "common/tree.py", "utils/metrics.py", "data/av2.py",
        "data/semantic_map.py", "data/loader.py", "sim/agents.py", "sim/simulator.py",
        "sim/state_io.py", "sim/replay.py", "run_sim.py", "synthetic.py",
        "native/__init__.py", "sim/episode.py", "parallel/__init__.py", "parallel/mesh.py",
        "parallel/scale.py", "parallel/multi_scenario.py", "parallel/monte_carlo.py",
        "models/train.py", "models/data_pipeline.py", "models/checkpoint.py",
        "models/weights.py", "train_weights.py", "parity/__init__.py", "parity/host_scene.py",
        "parity/host_ilqr.py", "parity/host_planner.py", "parity/runner.py", "parity_run.py",
        "planner/scenario_tree.py", "viz/render.py", "viz/video.py", "viz/raster.py",
        "viz/jpeg.py", "data/parquet.py", "common/observation.py",
        "utils/device_health.py", "utils/device_specs.py", "bench.py", "parallel/launch.py",
        "parallel/dryrun.py", *(f"scripts/{n}.py" for n in (
            "__init__", "run_all_demos", "bench_north_star", "bench_strict", "bench_exec_ab",
            "bench_unroll_ab", "diag_playback", "bench_forward_split", "bench_fusion",
            "bench_mc", "bench_scale", "render_demo_video", "run_evidence"))}


def test_native_source_is_the_ports_own():
    """exec_ilqr.cpp is built from the port's own copy, whose code (below its
    header comment) is the JAX package's."""
    ours = (ROOT / "mind_tpu_torch" / "native" / "exec_ilqr.cpp").read_text()
    theirs = (ROOT / "mind_tpu" / "native" / "exec_ilqr.cpp").read_text()
    start = "#include <cmath>"
    assert ours[ours.index(start):] == theirs[theirs.index(start):]
    assert "mind_tpu/native" not in (ROOT / "mind_tpu_torch" / "native" / "__init__.py").read_text(
        ).split('"""')[2]
