"""Each partition twin of ``examples_torch/`` end to end as a user runs it,
``main(["--device", "cpu"])``, in a process where neither jax nor the
reference package gets loaded; its printed figures are the reference
example's."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: lines (or parts of lines) each twin prints, as the reference's example
#: prints them on the same inputs
PRINTED = {
    "quickstart": ("|V|=6,458 |E|=110,716  k=32",
                   "|V|=9,216 |E|=257,434  k=32",
                   "2PS-L    rf= 6.460 alpha=1.050",
                   "HDRF     rf= 3.893 alpha=1.002",
                   "DBH      rf= 4.899 alpha=1.154",
                   "random   rf=10.780 alpha=1.033",
                   "2PS-L    rf= 6.182 alpha=1.050",
                   "HDRF     rf= 6.551 alpha=1.001"),
    "out_of_core_partition": (
        "(|V|=12,536 |E|=227,976)",
        "1.962     1.738    1.795", "6.275     3.781    4.726",
        "10.364     5.806    8.435",
        "artifact reload: spec=2psl rf=6.275; cached halo plan "
        "(b_cap=2055)"),
    "partition_and_train_gnn": (
        "graph: |V|=4,096 |E|=39,740",
        "2psl    rf= 4.306 sync=    6.61 MiB/layer  halo-plan: v_cap=2826 "
        "e_cap=5216 b_cap=1687",
        "random  rf= 7.254 sync=   12.51 MiB/layer  halo-plan: v_cap=3733 "
        "e_cap=4995 b_cap=3399",
        "2 hosts: aggregated DCN lanes ship 6886 rows/layer vs 41694 "
        "pairwise (6.05x less DCN traffic)",
        "cross-host rf 1.8406 -> 1.8220, DCN rows/layer 6886 -> 6734, "
        "alpha=1.050",
        "trained 200 steps in"),
}


@pytest.mark.parametrize("name", sorted(PRINTED))
def test_partition_twin_main_runs_without_jax_or_repro(name, tmp_path):
    code = (
        "import importlib.util, sys\n"
        f"path = {str(ROOT / 'examples_torch' / (name + '.py'))!r}\n"
        "spec = importlib.util.spec_from_file_location('twin', path)\n"
        "twin = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(twin)\n"
        "twin.main(['--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    # one intra-op thread: the engine's small eager operations run no
    # faster on more, and several test workers share the host's cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN")
    for part in PRINTED[name]:
        assert part in out.stdout, (part, out.stdout)
