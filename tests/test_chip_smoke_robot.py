"""chip_smoke.py's single-robot phase on the CPU: run.main's trot at 0.3 m/s
for 2 s, on ground truth and with the estimator, within the trot bounds."""

import chip_smoke


def test_phase_single_robot():
    fields, guards = chip_smoke.phase_single_robot()
    bad = {k: g for k, g in guards.items() if not g["ok"]}
    assert guards and not bad, bad
    for name in ("truth", "estimator"):
        assert len(fields[name]["run_s"]) == 2
        assert fields[name]["compile_s"] > 0
