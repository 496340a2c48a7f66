"""chip_smoke.py's phase functions, called directly on the CPU at small
batches: every guard must hold.  (The script itself refuses to run without
a GPU; tests/test_entry_points.py checks that.)"""

import json
import os
import subprocess
import sys
import textwrap

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_guards(guards):
    assert guards
    bad = {k: g for k, g in guards.items() if not g["ok"]}
    assert not bad, bad


def test_phase_sweep_b2():
    fields, guards = chip_smoke.phase_sweep(total=4, chunk=2, periods=2,
                                            cpu_n=2)
    _assert_guards(guards)
    assert fields["summary"]["scenarios"] == 4


def test_phase_host():
    fields, guards = chip_smoke.phase_host(n_ticks=40)
    _assert_guards(guards)
    assert fields["loop_hz"] > 0


def test_phase_parity_b2():
    _, guards = chip_smoke.phase_parity(cascade_batch=2)
    _assert_guards(guards)


FOUR_DEVICES = textwrap.dedent("""
    import json
    import chip_smoke
    fields, guards = chip_smoke.phase_four_gpus(batch=8, periods=1,
                                                ref_per_shard=1, chunk=1)
    print(json.dumps({"fields": {"batch": fields["batch"],
                                 "chunk": fields["chunk"]},
                      "guards": guards}, default=float))
""")


def test_phase_four_gpus_on_four_cpu_devices():
    """The sharded path and its comparisons on 4 virtual CPU devices, two
    chunks of one scenario per device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", FOUR_DEVICES], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["fields"]["batch"] == 8 and out["fields"]["chunk"] == 1
    _assert_guards(out["guards"])
