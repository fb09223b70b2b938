"""``cobevt_tpu_torch/tools/test_report.py``, the copy of the JAX package's
tool: its lanes, junit parsing and artifact, on a temporary directory of
one test file (the tool's repo root is pointed there, so the repo's own
suite never runs), against the JAX tool on the same directory."""

import json

import pytest

from cobevt_tpu.tools import test_report as jax_report
from cobevt_tpu_torch.tools import test_report

SUITE = '''
import pytest


def test_passes():
    assert True


def test_fails():
    assert False


@pytest.mark.skip(reason="skipped on purpose")
def test_skipped():
    pass


@pytest.mark.slow
def test_slow():
    pass
'''

EXTRA = ["-p", "no:cacheprovider", "-p", "no:randomly", "-W",
         "ignore::pytest.PytestUnknownMarkWarning"]


@pytest.fixture
def root(tmp_path, monkeypatch):
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_one.py").write_text(SUITE)
    for module in (test_report, jax_report):
        monkeypatch.setattr(module, "REPO_ROOT", str(tmp_path))
    return tmp_path


def test_lanes_are_the_jax_tools():
    assert test_report.LANES == jax_report.LANES


def test_run_lane_parses_the_junit_counts(root):
    row = test_report.run_lane("fast", EXTRA, str(root / "fast.xml"))
    want = jax_report.run_lane("fast", EXTRA, str(root / "jax.xml"))
    assert row.pop("duration_s") >= 0 and want.pop("duration_s") >= 0
    assert row == want
    assert row["exit_code"] == 1
    assert (row["collected"], row["passed"], row["failed"], row["errors"],
            row["skipped"]) == (3, 1, 1, 0, 1)
    assert row["failing"] == ["tests.test_one::test_fails"]


def test_missing_junit_reports_the_tail(root):
    row = test_report.run_lane("slow", EXTRA + ["--no-such-option"],
                               str(root / "none.xml"))
    assert row["exit_code"] != 0 and "parse_error" in row
    assert "tail" in row


def test_main_writes_the_artifact(root, monkeypatch):
    out = root / "report.json"
    monkeypatch.setattr("sys.argv", ["test_report", "--lanes", "slow",
                                     "--out", str(out), "--", *EXTRA])
    assert test_report.main() == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True
    assert [lane["lane"] for lane in report["lanes"]] == ["slow"]
    assert report["lanes"][0]["passed"] == 1
