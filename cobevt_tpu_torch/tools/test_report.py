"""Run the test suite and write an artifact of its result.

Counterpart of ``cobevt_tpu/tools/test_report.py``, with the same lanes,
the same junit parsing and the same JSON artifact.  Each lane (fast =
``-m 'not slow'``, slow = ``-m slow``) runs as a pytest subprocess in the
repo root with junit XML output; the counts of each lane are parsed from
the XML and written to one JSON file (``TESTS_r0N.json`` at the repo root
with ``--round N``, or ``--out``).

  python -m cobevt_tpu_torch.tools.test_report --round 4
  python -m cobevt_tpu_torch.tools.test_report --lanes fast --out /tmp/t.json

Arguments after the options are passed on to pytest (``run_lane``'s
``extra``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LANES = {
    "fast": ["-m", "not slow"],
    "slow": ["-m", "slow"],
}


def run_lane(name: str, extra: list[str], xml_path: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q",
         "--junitxml", xml_path, *LANES[name], *extra],
        cwd=REPO_ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    row = {"lane": name, "exit_code": proc.returncode,
           "duration_s": round(wall, 1)}
    try:
        suite = ET.parse(xml_path).getroot().find("testsuite")
        tests = int(suite.get("tests", 0))
        failures = int(suite.get("failures", 0))
        errors = int(suite.get("errors", 0))
        skipped = int(suite.get("skipped", 0))
        row.update(collected=tests, passed=tests - failures - errors -
                   skipped, failed=failures, errors=errors,
                   skipped=skipped)
        if failures or errors:
            row["failing"] = sorted({
                f"{c.get('classname')}::{c.get('name')}"
                for c in suite.iter("testcase")
                if c.find("failure") is not None
                or c.find("error") is not None})[:20]
    except Exception as e:  # junit xml missing => collection crashed
        row["parse_error"] = str(e)
        row["tail"] = proc.stdout[-2000:] + proc.stderr[-500:]
    return row


def main() -> int:
    p = argparse.ArgumentParser("cobevt_tpu_torch test report")
    p.add_argument("--round", type=int, default=None,
                   help="write TESTS_r0N.json at the repo root")
    p.add_argument("--out", default=None, help="explicit output path")
    p.add_argument("--lanes", default="fast,slow")
    p.add_argument("pytest_args", nargs="*",
                   help="extra args forwarded to pytest")
    opt = p.parse_args()

    git = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         cwd=REPO_ROOT, capture_output=True, text=True)
    report = {"commit": git.stdout.strip(),
              "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
              "lanes": []}
    ok = True
    for lane in opt.lanes.split(","):
        lane = lane.strip()
        if lane not in LANES:
            raise SystemExit(f"unknown lane {lane!r} (have {list(LANES)})")
        row = run_lane(lane, opt.pytest_args, os.path.join(
            tempfile.gettempdir(), f"pytest_{lane}.xml"))
        report["lanes"].append(row)
        ok = ok and row["exit_code"] in (0, 5)  # 5 = nothing collected
        print(json.dumps(row), flush=True)

    report["ok"] = ok
    out = opt.out or (os.path.join(REPO_ROOT, f"TESTS_r{opt.round:02d}.json")
                      if opt.round else None)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
