"""``parallel_probe.py``'s bounded runs: a run that passes its limit is
killed with its whole process group and named, with its log's tail, each
rank's last stage and stack, and the probe exits non-zero (seconds on
the CPU)."""

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import parallel_probe as pp  # noqa: E402

# two spawned ranks that say where they are, then wait in ``stall_here``
STALL = '''
import multiprocessing as mp, os, sys, time

def stall_here(rank, pids):
    with open(pids + str(rank), "w") as f:
        f.write(str(os.getpid()))
    sys.stderr.write(f"stall test, rank {rank} of 2: waiting\\n")
    sys.stderr.flush()
    time.sleep(600)

if __name__ == "__main__":
    print("leader up", flush=True)
    ctx = mp.get_context("spawn")
    ranks = [ctx.Process(target=stall_here, args=(r, sys.argv[1]))
             for r in range(2)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join()
'''


def gone(pid):
    st = pp._stat(pid)
    return st is None or st[0] in "ZX"


def wait_for(paths, seconds=20):
    deadline = time.monotonic() + seconds
    while not all(os.path.exists(p) and os.path.getsize(p) for p in paths):
        assert time.monotonic() < deadline, "the ranks did not start"
        time.sleep(0.05)


def test_a_stalled_run_is_killed_with_its_group_and_named(tmp_path, capsys):
    script = tmp_path / "stall.py"
    script.write_text(STALL)
    pids = str(tmp_path / "pid")
    log = tmp_path / "stall.log"
    limit = 6
    t0 = time.monotonic()
    with pytest.raises(pp.RunFailed, match="9_stall"):
        pp.bounded("9_stall", [sys.executable, str(script), pids], limit,
                   str(log))
    took = time.monotonic() - t0
    out = capsys.readouterr().out
    # killed within its limit and a few seconds (the two stack dumps)
    assert took < limit + 10, took
    wait_for([pids + "0", pids + "1"], 0)
    for r in range(2):
        assert gone(int(open(pids + str(r)).read()))
    # the report names the run and its limit, prints the log's tail, each
    # rank's last stage and where its stack stood
    assert "run 9_stall stopped at its limit of 6 s" in out
    assert "  | leader up" in out
    assert "rank 0, last stage: waiting" in out
    assert "rank 1, last stage: waiting" in out
    stacks = out.split("rank 0, stack (innermost first):")[1]
    assert "in stall_here" in stacks
    assert "rank 1, stack (innermost first):" in stacks


def test_a_failed_run_prints_its_tail(tmp_path, capsys):
    log = tmp_path / "fail.log"
    lines = "; ".join(f"print('line {i}')" for i in range(40))
    with pytest.raises(pp.RunFailed):
        pp.bounded("9_fail", [sys.executable, "-c",
                              lines + "; raise SystemExit(3)"], 60, str(log))
    out = capsys.readouterr().out
    assert "run 9_fail exited 3" in out
    tail = [line for line in out.splitlines() if line.startswith("  | ")]
    assert tail == [f"  | line {i}" for i in range(10, 40)]


def test_a_clean_run_leaves_no_process(tmp_path):
    pid_file = tmp_path / "pid"
    pp.bounded("9_clean", ["sh", "-c", f"sleep 600 & echo $! > {pid_file}"],
               60, str(tmp_path / "clean.log"))
    assert gone(int(pid_file.read_text()))


def test_the_probe_exits_nonzero_when_a_run_stalls(tmp_path, monkeypatch,
                                                   capsys):
    """``--entry``'s first run replaced by one that sleeps past a short
    limit: the probe ends it, names it and exits non-zero."""
    marker = tmp_path / "ran"
    monkeypatch.setattr(pp, "OUT", str(tmp_path / "out"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(pp, "LIMITS", dict(pp.LIMITS, **{"1_data": (2, 2)}))
    monkeypatch.setattr(pp, "spawn_cmd", lambda *a: [
        "sh", "-c", f"echo stalled > {marker}; sleep 600"])
    monkeypatch.setattr(sys, "argv", ["parallel_probe.py", "--entry",
                                      "--cpu", "--procs", "2"])
    t0 = time.monotonic()
    rc = pp.main()
    assert time.monotonic() - t0 < 60
    assert rc != 0 and marker.exists()
    out = capsys.readouterr().out
    assert "run 1_data stopped at its limit of 2 s" in out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "ok": False, "failed_run": "1_data"}
    assert os.path.exists(os.path.join(tmp_path, "out", "entry_1_data.log"))


def test_main_stack_reads_a_faulthandler_dump():
    dump = subprocess.run(
        [sys.executable, "-c",
         "import faulthandler, threading, time\n"
         "threading.Thread(target=time.sleep, args=(60,), daemon=True)"
         ".start()\n"
         "def inner():\n    faulthandler.dump_traceback()\n"
         "inner()\n"], capture_output=True, text=True).stderr
    frames = pp.main_stack(dump)
    assert frames and "in inner" in frames[0]
    assert frames[-1].endswith("in <module>")
