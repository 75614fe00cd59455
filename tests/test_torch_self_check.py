"""The port's tools of the self-contained gate on the CPU: gen_inputs against
tools/gen_inputs.py, check_self passing and failing, bench_all's table,
and gen_goldens' refusal to overwrite."""

import contextlib
import dataclasses
import io as stdio
import shutil

import pytest

from lbm_tpu_torch import config
from lbm_tpu_torch.tools import bench_all, check_self, gen_goldens, gen_inputs
from tools import gen_inputs as jax_gen_inputs

CASES = ("128x128", "128x256", "256x256", "1024x1024")


def _main(main, argv):
    out = stdio.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("case, flags", [(c, []) for c in CASES] + [
    ("256x256", ["--max-iters", "1000"]),
    (None, ["--nx", "48", "--ny", "20", "--accel", "0.0075", "--omega", "1.7"]),
], ids=list(CASES) + ["max-iters", "custom-grid"])
def test_gen_inputs_byte_equal_to_tools(tmp_path, case, flags):
    """Both tools from one command line: the same files, byte for byte."""
    for main, out in ((gen_inputs.main, "ours"), (jax_gen_inputs.main, "theirs")):
        assert _main(main, [*([case] if case else []), str(tmp_path / out), *flags])[0] == 0
    ours = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "theirs").iterdir()) and len(ours) == 2
    for name in ours:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()


def test_check_self_passes_a_prefix(tmp_path, monkeypatch):
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    rc, out = _main(check_self.main, ["--case", "128x128", "--max-iters", "200",
                                      "--workdir", str(tmp_path)])
    assert rc == 0, out
    line, = out.splitlines()
    assert line.startswith("PASS 128x128: 200 steps")
    assert "final_state not checked" in line and "native I/O" in line


@pytest.fixture()
def short_128(tmp_path, monkeypatch):
    """128x128 cut to 60 steps as its full length, with goldens of that
    length made by the port's fp64 engine (gen_goldens) in a directory of
    their own: check_self then checks final_state too."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    monkeypatch.setitem(config.CANONICAL_PARAMS, "128x128", dataclasses.replace(
        config.CANONICAL_PARAMS["128x128"], max_iters=60))
    goldens = tmp_path / "goldens"
    goldens.mkdir()
    r = gen_goldens.generate("128x128", goldens)
    assert r["written"] == ["128x128.fp64gen_av_vels.dat",
                            "128x128.fp64gen_final_state.dat"]
    assert r["av_ok"] and r["av_text_differs"] == 0
    monkeypatch.setattr(check_self, "GOLDENS", goldens)
    return goldens


def _perturb(path, column, factor, first, last):
    """Scale ``column`` of lines ``[first, last)`` of a golden file."""
    lines = path.read_text().splitlines()
    for i in range(first, last):
        parts = lines[i].split()
        parts[column] = format(float(parts[column]) * factor, ".12E")
        lines[i] = ("\t" if parts[0].endswith(":") else " ").join(parts)
    path.write_text("\n".join(lines) + "\n")


def test_check_self_checks_final_state_and_fails_a_perturbed_golden(tmp_path, short_128):
    argv = ["--case", "128x128", "--workdir", str(tmp_path / "work")]
    rc, out = _main(check_self.main, argv)
    assert rc == 0, out
    assert "PASS 128x128: 60 steps" in out and "final_state checked" in out

    shutil.copy(short_128 / "128x128.fp64gen_final_state.dat", tmp_path / "fs.bak")
    _perturb(short_128 / "128x128.fp64gen_final_state.dat", 5, 1.02, 3000, 3010)
    rc, out = _main(check_self.main, argv)
    assert rc == 1 and "FAIL 128x128" in out and "FAILED: 128x128" in out

    shutil.copy(tmp_path / "fs.bak", short_128 / "128x128.fp64gen_final_state.dat")
    _perturb(short_128 / "128x128.fp64gen_av_vels.dat", 1, 1.02, 40, 41)
    rc, out = _main(check_self.main, argv)
    assert rc == 1 and "FAIL 128x128" in out


def test_bench_all_table_parses(monkeypatch):
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    argv = ["--case", "128x128", "--case", "128x256", "--max-iters", "20", "--repeats", "1"]
    rc, out = _main(bench_all.main, [*argv, "--markdown"])
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[0] == "Device: cpu"
    header = [c.strip() for c in lines[1].strip("|").split("|")]
    assert header == ["Case", "iters", "seconds", "wall s", "MLUPS", "vs K20m", "max diff",
                      "Re"]
    rows = [[c.strip() for c in line.strip("|").split("|")] for line in lines[3:5]]
    assert [r[0] for r in rows] == ["128x128", "128x256"]
    for r in rows:
        assert int(r[1]) == 20
        seconds, wall, mlups = float(r[2]), float(r[3]), float(r[4])
        assert 0 < seconds <= wall and mlups > 0
        assert float(r[5].rstrip("x")) >= 0 and 0 <= float(r[6].rstrip("%")) < 1
        assert float(r[7]) > 0
    rc, out = _main(bench_all.main, [*argv, "--tolerance", "0"])
    assert rc == 1 and out.splitlines()[-1].startswith("FAILED tolerance 0.0%")


def test_bench_all_prefers_the_reference_goldens(tmp_path, monkeypatch):
    """A reference check/ directory's av_vels take precedence over the
    vendored series: 2% off there fails the 1% gate."""
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    argv = ["--case", "128x128", "--max-iters", "20", "--repeats", "1"]
    shutil.copy(check_self.GOLDENS / "128x128.fp64gen_av_vels.dat",
                tmp_path / "128x128.av_vels.dat")
    _perturb(tmp_path / "128x128.av_vels.dat", 1, 1.02, 10, 11)
    assert _main(bench_all.main, [*argv, "--reference-check", str(tmp_path)])[0] == 1
    assert _main(bench_all.main, [*argv, "--reference-check", str(tmp_path / "none")])[0] == 0


def test_gen_goldens_never_overwrites(tmp_path, monkeypatch):
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    before = {p.name: p.read_bytes() for p in gen_goldens.GOLDENS.iterdir()}
    rc, out = _main(gen_goldens.main, ["--case", "128x128"])
    assert rc == 1 and "never overwritten" in out
    argv = ["--case", "128x256", "--outdir", str(tmp_path), "--max-iters", "12"]
    rc, out = _main(gen_goldens.main, argv)
    assert rc == 0 and "0 of 12 lines differ in text" in out
    assert [p.name for p in tmp_path.iterdir()] == ["128x256.fp64gen_av_vels.dat"]
    rc, out = _main(gen_goldens.main, argv)
    assert rc == 1 and "never overwritten" in out
    assert {p.name: p.read_bytes() for p in gen_goldens.GOLDENS.iterdir()} == before
