"""``chip_smoke.py`` runs its late phases (``LATE_GROUPS``) in two more
processes beside the others (``chip_smoke.Beside``). Its plumbing runs here
on small stand-in processes: the relayed output and the returned JSON, a
failing process, a process still running at the deadline (it and the
process it started are ended), and ``--late`` without a card."""

import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "imid+observe | "
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _beside(tmp_path, code):
    out = str(tmp_path / "late.json")
    return chip_smoke.Beside([sys.executable, "-c", code, out], out, PREFIX)


def _ended(pid, within=10.0):
    """True once ``pid`` is gone or a zombie, waiting up to ``within`` s."""
    t_end = time.monotonic() + within
    while time.monotonic() < t_end:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X"):
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.05)
    return False


def test_beside_relays_its_lines_and_returns_its_json(tmp_path, capsys):
    late = _beside(tmp_path, (
        "import json, sys\n"
        "print('[imid] done in 1.00 s')\n"
        "print('to stderr', file=sys.stderr)\n"
        "json.dump({'imid': 3, 'mesh': 8}, open(sys.argv[1], 'w'))\n"))
    try:
        assert late.join(60) == {"imid": 3, "mesh": 8}
    finally:
        late.stop()
    lines = capsys.readouterr().out.splitlines()
    assert PREFIX + "[imid] done in 1.00 s" in lines
    assert PREFIX + "to stderr" in lines


def test_beside_raises_when_it_fails(tmp_path):
    late = _beside(tmp_path, "raise SystemExit(3)")
    try:
        with pytest.raises(RuntimeError, match="exit code 3"):
            late.join(60)
    finally:
        late.stop()


def test_beside_is_ended_at_the_deadline_with_what_it_started(tmp_path,
                                                             capsys):
    late = _beside(tmp_path, (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(120)'])\n"
        "print('grandchild', p.pid, flush=True)\n"
        "time.sleep(120)\n"))
    try:
        pid, t_end = None, time.monotonic() + 60
        while pid is None and time.monotonic() < t_end:
            for line in capsys.readouterr().out.splitlines():
                if line.startswith(PREFIX + "grandchild"):
                    pid = int(line.split()[-1])
            time.sleep(0.05)
        assert pid is not None
        with pytest.raises(RuntimeError, match="still running"):
            late.join(0.5)
    finally:
        late.stop()
    assert late.proc.returncode is not None
    assert _ended(pid)


def test_late_groups_hold_each_late_phase_once():
    phases = [p for group in chip_smoke.LATE_GROUPS for p in group]
    assert sorted(phases) == ["batch", "imid", "mesh", "observe", "tools"]


def test_late_needs_a_card(tmp_path):
    if chip_smoke.torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = tmp_path / "late.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                           "--late", "batch,tools", str(out)],
                          capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert not out.exists()


def test_busy_time_counts_overlapping_activities_once():
    """The smoke's busy shares take the union of the device intervals."""
    events = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 1.0),
              ("d", 16.0, 2.0)]
    assert chip_smoke.union_us(events) == pytest.approx(18.0)
    assert chip_smoke.union_us([]) == 0.0
