"""Import hygiene of the port: nothing under ``src/repro_torch`` and
nothing in ``chip_smoke.py`` or its ``dist_check.py`` imports JAX or the JAX package (``repro``).
Found by an AST scan, so imports inside functions count too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "dist_check.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("src/repro_torch/serving/engine.py",
                 "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/bridge.py", "chip_smoke.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/kernels/lowrank_matmul.py",
                 "src/repro_torch/kernels/wkv6.py",
                 "src/repro_torch/kernels/ssd.py",
                 "src/repro_torch/models/rwkv.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/spec/config.py",
                 "src/repro_torch/spec/decoder.py",
                 "src/repro_torch/serving/session.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/models/tp.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/costmodel.py",
                 "src/repro_torch/launch/specs.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/trace_analysis.py",
                 "src/repro_torch/obs/metrics.py",
                 "src/repro_torch/obs/ringtrace.py",
                 "src/repro_torch/obs/watchdog.py",
                 "src/repro_torch/obs/statusz.py",
                 "src/repro_torch/obs/costaudit.py",
                 "src/repro_torch/obs/profiling.py",
                 "src/repro_torch/optim/muon.py",
                 "src/repro_torch/optim/compression.py",
                 "src/repro_torch/checkpoint/manager.py",
                 "src/repro_torch/core/nestedness.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/distributed/__init__.py",
                 "src/repro_torch/distributed/world.py",
                 "src/repro_torch/distributed/meshctx.py",
                 "src/repro_torch/distributed/sharding.py",
                 "src/repro_torch/distributed/collectives.py",
                 "dist_check.py",
                 "src/repro_torch/core/covariance.py",
                 "src/repro_torch/core/profiles.py"):
        assert must in names
