"""chip_smoke.py's phases, rehearsed here at a tiny size.

On the GPU chip_smoke.py runs every phase at full width against the f64
oracles; here each phase runs with the kernels in the Pallas interpreter, so
a broken phase (wrong arguments, shapes, control flow) fails before it
reaches the card. The four-card phase runs on the virtual CPU mesh.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    K=100, T=8, ticks=5, K_oracle=64,
    race_K=96, race_T=6, race_K_oracle=32,
    nmpc_N=8, nmpc_ticks=4, nmpc_B=4,
    fleet_B=3, fleet_K=64, fleet_T=8,
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["flagship", "racecar", "nmpc", "fleet"])
def test_phase_rehearses_on_cpu(phase, f32_mode, capsys):
    cs = _chip_smoke()
    chk = cs.Checker()
    getattr(cs, f"phase_{phase}")(chk, SMALL, True)
    out = capsys.readouterr().out
    # every comparison prints its error beside its tolerance and precision
    assert "tol" in out
    assert not chk.failed, out


def test_four_device_phase_rehearses_on_virtual_mesh(f32_mode, capsys):
    cs = _chip_smoke()
    chk = cs.Checker()
    cs.phase_four_chips(chk, True, K1=32, T=6, B_mppi=1, K_fleet=32, B_nmpc=8, N=6)
    assert not chk.failed, capsys.readouterr().out


def test_full_sizes_are_the_documented_widths():
    cs = _chip_smoke()
    assert (cs.FULL["K"], cs.FULL["T"]) == (10_240, 50)
    assert (cs.FULL["race_K"], cs.FULL["race_T"]) == (10_240, 20)
    assert cs.FULL["nmpc_N"] == 30 and cs.FULL["nmpc_B"] == 128
    assert (cs.FULL["fleet_B"], cs.FULL["fleet_K"], cs.FULL["fleet_T"]) == (16, 1024, 50)
