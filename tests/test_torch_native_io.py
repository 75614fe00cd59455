"""The native host I/O (lbm_tpu_torch/_native/lbmio.c) against the
pure-Python writers and parser: the same bytes, the same masks and free
counts, the same errors; its build and its loud fallback.  Float32 values
take the writers' exact converter and every other double the C library's
``%.12E``, as the writers' spans count."""

import dataclasses
import errno
import math
import pathlib
import threading
from decimal import Decimal

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import lbm_tpu.config as jax_config
import lbm_tpu.geometry as jax_geometry
import lbm_tpu.io as jax_io
from lbm_tpu_torch import _native, config, geometry, io
from lbm_tpu_torch.utils import profiling


@pytest.fixture()
def lib():
    if _native.find_compiler() is None:
        pytest.skip("no C compiler (sysconfig CC, cc): the native I/O cannot be built")
    lib = _native.library()
    assert lib is not None
    return lib


def _special_values() -> np.ndarray:
    """NaN of both signs, the infinities, -0.0, denormals, and values whose
    13th significant digit rounds on a 5 or near it."""
    neg_nan = np.copysign(np.float64("nan"), -1.0)
    assert math.copysign(1.0, neg_nan) < 0
    edges = [float(f"{m}5e{e}") for m in ("1.23456789012", "9.99999999999", "5.00000000000")
             for e in (-300, -5, 0, 7, 300)]
    vals = [np.nan, neg_nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -5e-324,
            2.2250738585072009e-308, 1.7976931348623157e308, 1.0000000000005,
            0.99999999999995, *edges, *(np.nextafter(e, np.inf) for e in edges),
            *(np.nextafter(e, -np.inf) for e in edges)]
    return np.array(vals, dtype=np.float64)


def _columns(ny, nx, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.standard_normal((ny, nx)) * 10.0 ** rng.integers(-12, 3, (ny, nx))
            for _ in range(4)]
    special = _special_values()
    for c in cols:
        flat = c.reshape(-1)
        k = min(flat.size, special.size)
        flat[:k] = rng.permutation(special)[:k]
    return cols, rng.random((ny, nx)) < 0.3


@pytest.mark.parametrize("ny, nx", [(128, 128), (37, 53), (1, 1)])
def test_final_state_byte_identical(tmp_path, monkeypatch, lib, ny, nx):
    cols, obstacles = _columns(ny, nx, seed=ny * 1000 + nx)
    io.write_final_state_python(tmp_path / "py.dat", cols, obstacles)
    assert _native.write_final_state(tmp_path / "c.dat", cols, obstacles)
    assert (tmp_path / "py.dat").read_bytes() == (tmp_path / "c.dat").read_bytes()
    # The public writer, from a fields payload, against lbm_tpu's
    # pure-Python one (values beyond fp32 become infinities).
    params = config.LBMParams(nx, max(ny, 2), 1, 10, 0.1, 0.005, 1.85)
    jparams = jax_config.LBMParams(**dataclasses.asdict(params))
    with np.errstate(over="ignore"):
        fields = np.stack(cols).astype(np.float32)
    io.write_final_state(tmp_path / "ours.dat", params, None, obstacles, fields=fields)
    monkeypatch.setattr(jax_io, "_lbmio", None)
    jax_io.write_final_state(tmp_path / "theirs.dat", jparams, None, obstacles, fields=fields)
    assert (tmp_path / "ours.dat").read_bytes() == (tmp_path / "theirs.dat").read_bytes()


def test_special_values_are_written_as_python_writes_them(tmp_path, lib):
    av = _special_values()
    io.write_av_vels_python(tmp_path / "py.dat", av)
    assert _native.write_av_vels(tmp_path / "c.dat", av)
    text = (tmp_path / "c.dat").read_text()
    assert text == (tmp_path / "py.dat").read_text()
    assert "0:\tNAN\n1:\tNAN\n2:\tINF\n3:\t-INF\n4:\t-0.000000000000E+00\n" in text
    assert "E-324" in text and "E+308" in text


@settings(max_examples=150, deadline=None)
@given(st.lists(st.floats(allow_nan=True, allow_infinity=True, width=64), min_size=0,
                max_size=40))
def test_av_vels_byte_identical(tmp_path_factory, values):
    if _native.find_compiler() is None:
        pytest.skip("no C compiler (sysconfig CC, cc): the native I/O cannot be built")
    d = tmp_path_factory.mktemp("av")
    av = np.array(values, dtype=np.float64)
    io.write_av_vels_python(d / "py.dat", av)
    assert _native.write_av_vels(d / "c.dat", av)
    assert (d / "py.dat").read_bytes() == (d / "c.dat").read_bytes()


def _float32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32).astype(np.float64)


def _both_signs(v: np.ndarray) -> np.ndarray:
    return np.concatenate([v, -v])


def _every_exponent() -> np.ndarray:
    """Every float32 binary exponent, denormals included, with the least
    and the largest mantissa and 64 seeded ones."""
    mantissas = np.concatenate([[0, (1 << 23) - 1],
                                np.random.default_rng(21).integers(1, 1 << 23, 64)])
    bits = (np.arange(255)[:, None] << 23) | mantissas[None, :]
    return _both_signs(_float32(bits.ravel()))


def _powers_of_ten() -> np.ndarray:
    """The float32 nearest each power of ten from 1e-45 to 1e38, and its
    two float32 neighbours."""
    p = np.array([10.0 ** e for e in range(-45, 39)]).astype(np.float32)
    near = [p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf))]
    return _both_signs(np.concatenate(near).astype(np.float64))


def _carries() -> np.ndarray:
    """Seeded float32 values whose 13 digits round up across the longest
    runs of nines.  A float32 lies 2^-24 of itself from its neighbours, far
    beyond the 5e-14 below a power of ten from which 13 digits round up to
    the next decade: the longest carries come nearest it."""
    bits = np.random.default_rng(23).integers(0x00800000, 0x7F800000, 100_000)
    vals = _float32(bits)

    def carry(v: float) -> int:
        short, long = format(v, ".12E")[:14], format(v, ".20E")[:14]
        return 0 if short == long else len(long) - len(long.rstrip("9"))

    runs = np.array([carry(v) for v in vals])
    return _both_signs(vals[np.argsort(-runs, kind="stable")[:64]])


def _ties() -> np.ndarray:
    """m * 2^-k for odd m < 2^24 where m * 5^k has exactly 14 digits: the
    exact expansion ends in a 14th digit of 5, so 13 digits round half to
    even (k from 9 to 19; below 9 no such m is below 2^24)."""
    rng = np.random.default_rng(24)
    vals = []
    for k in range(9, 20):
        lo, hi = -(-10**13 // 5**k), min(1 << 24, 10**14 // 5**k)
        ms = {lo | 1, (hi - 1) | 1, *(int(m) | 1 for m in rng.integers(lo, hi, 256))}
        vals += [m * 2.0**-k for m in sorted(ms) if m < hi]
    for v in vals:
        digits = Decimal(v).as_tuple().digits
        assert len(digits) == 14 and digits[-1] == 5
    return _both_signs(np.array(vals))


FLOAT32_FAMILIES = {
    "every-exponent": _every_exponent,
    "zeros": lambda: np.array([0.0, -0.0]),
    "powers-of-ten": _powers_of_ten,
    "carries": _carries,
    "ties": _ties,
}


def _written(write, *args) -> dict:
    """The counts on the span of one native write under a profiler."""
    profiling.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        write(*args)
    (span,) = [s for s in profiling.take_spans() if s.name.startswith("io.")]
    return span.attrs


@pytest.mark.parametrize("family", list(FLOAT32_FAMILIES))
def test_float32_values_take_the_exact_path(tmp_path, lib, family):
    av = FLOAT32_FAMILIES[family]()
    assert np.array_equal(av.astype(np.float32).astype(np.float64), av)
    io.write_av_vels_python(tmp_path / "py.dat", av)
    attrs = _written(io.write_av_vels, tmp_path / "c.dat", av)
    assert (tmp_path / "c.dat").read_bytes() == (tmp_path / "py.dat").read_bytes()
    assert attrs == {"bytes": (tmp_path / "c.dat").stat().st_size, "values": av.size,
                     "libc": 0}


def test_values_beyond_float32_take_the_c_library(tmp_path, monkeypatch, lib):
    """fp64 columns mixing float32 values, other doubles, NaN and the
    infinities write lbm_tpu.io's bytes; ``libc`` counts the finite doubles
    that are not float32 values."""
    ny, nx = 29, 31
    cols, obstacles = _columns(ny, nx, seed=29)
    stack = np.stack(cols)
    with np.errstate(over="ignore"):
        stack.reshape(4, -1)[:, ::3] = stack.reshape(4, -1)[:, ::3].astype(np.float32)
        narrowed = stack.astype(np.float32).astype(np.float64)
    beyond = int((np.isfinite(stack) & (narrowed != stack)).sum())
    assert 0 < beyond < stack.size and np.isnan(stack).any() and np.isinf(stack).any()
    params = config.LBMParams(nx, ny, 1, 10, 0.1, 0.005, 1.85)
    attrs = _written(io.write_final_state, tmp_path / "ours.dat", params, None,
                     obstacles, stack)
    assert attrs["values"] == stack.size and attrs["libc"] == beyond
    monkeypatch.setattr(jax_io, "_lbmio", None)
    jparams = jax_config.LBMParams(**dataclasses.asdict(params))
    jax_io.write_final_state(tmp_path / "theirs.dat", jparams, None, obstacles, fields=stack)
    assert (tmp_path / "ours.dat").read_bytes() == (tmp_path / "theirs.dat").read_bytes()
    av = stack.ravel()
    io.write_av_vels_python(tmp_path / "py.dat", av)
    attrs = _written(io.write_av_vels, tmp_path / "c.dat", av)
    assert attrs["values"] == av.size and attrs["libc"] == beyond
    assert (tmp_path / "c.dat").read_bytes() == (tmp_path / "py.dat").read_bytes()


@pytest.mark.parametrize("n", [3, 100_000], ids=["at-close", "mid-file"])
@pytest.mark.parametrize("writer", ["final_state", "av_vels"])
def test_a_failed_open_or_write_raises_its_errno(tmp_path, lib, writer, n):
    values = np.full(n, 0.25)
    write = (lambda path: _native.write_av_vels(path, values)) if writer == "av_vels" else \
        (lambda path: _native.write_final_state(path, [values[None]] * 4,
                                                np.zeros((1, n), dtype=bool)))
    with pytest.raises(FileNotFoundError):
        write(tmp_path / "missing" / "out.dat")
    if not pathlib.Path("/dev/full").exists():
        pytest.skip("no /dev/full to fail a write on")
    # A block written mid-file, or the last one at close, fails with ENOSPC.
    with pytest.raises(OSError) as failed:
        write("/dev/full")
    assert failed.value.errno == errno.ENOSPC


def test_public_writers_take_the_native_path(tmp_path, lib):
    _native.reset_calls()
    obstacles = geometry.channel_box(16, 12)
    params = config.LBMParams(16, 12, 3, 10, 0.1, 0.005, 1.85)
    fields = np.random.default_rng(3).random((4, 12, 16)).astype(np.float32)
    io.write_final_state(tmp_path / "fs.dat", params, None, obstacles, fields=fields)
    io.write_av_vels(tmp_path / "av.dat", fields[0, 0])
    assert _native.CALLS == {"write_final_state": 1, "write_av_vels": 1,
                             "parse_obstacles": 0}


# (file bytes, what it tests): each valid file parses to the same mask and
# free count, each malformed one raises the pure-Python parser's error.
OBSTACLE_FILES = [
    (b"1 2 1\n3 4 1\n1 2 1\n", "duplicate"),
    (b"1 2 1\r\n3 4 1\r5 5 1", "crlf-cr-no-final-newline"),
    (b"\x0c\n  \t1\x1c2\x1f1 \x0b\n\n", "ascii-whitespace"),
    (b"-0 +2 +01\n", "signs"),
    (b"", "empty"),
    (b"1 2 1\n   ", "blank-last-line"),
    (b"\r\r1 2 1\r", "cr-lines"),
    (b"1 2\n", "two-values"),
    (b"1 2 1 1\n", "four-values"),
    (b"1_2 2 1\n", "underscore"),
    (b"0x1 2 1\n", "hex"),
    (b"1.0 2 1\n", "float"),
    (b"+ 2 1\n", "bare-sign"),
    (b"--1 2 1\n", "double-sign"),
    (b"1\x002 2 1\n", "nul-in-token"),
    (b"\x00\n", "nul-alone"),
    (b"40 2 1\n", "x-range"),
    (b"1 -1 1\n", "y-range"),
    (b"1 20 1\n", "y-range-edge"),
    (b"1 2 0\n", "blocked"),
    (b"1 2 100000000000000000000001\n", "blocked-huge"),
    (b"99999999999999999999999 1 1\n", "x-huge"),
    (b"-99999999999999999999 1 1\n", "x-huge-negative"),
    (b"1 2 1\n1 2 3\n", "second-line"),
    (b"1 2 1\n5 5 1\xa0\n", "invalid-utf8"),
    ("1 2 1\n5\u00a05 1\n".encode(), "utf8-nbsp-separator"),
    ("1 2\n\u00e9\n".encode(), "error-then-non-ascii"),
]


def _outcome(fn, path):
    try:
        mask, free = fn(path, 30, 20)
    except Exception as e:  # the outcome compared is the exception itself
        return type(e), str(e)
    return mask.dtype, mask.tobytes(), free


@pytest.mark.parametrize("data", [t for t, _ in OBSTACLE_FILES],
                         ids=[i for _, i in OBSTACLE_FILES])
def test_parser_matches_python(tmp_path, lib, data):
    path = tmp_path / "obstacles.dat"
    path.write_bytes(data)
    want = _outcome(geometry.parse_obstacles_python, path)
    _native.reset_calls()
    assert _outcome(geometry.load_obstacle_file, path) == want
    ascii_only = all(b < 0x80 for b in data)
    valid = not isinstance(want[0], type)
    # ASCII files are the native parser's (a valid one counts a call); a
    # byte beyond ASCII hands the file to the pure-Python parser.
    assert _native.CALLS["parse_obstacles"] == int(ascii_only and valid)
    if valid:
        theirs, free = jax_geometry.load_obstacle_file(path, 30, 20)
        assert want[1] == theirs.tobytes() and want[2] == free


def test_parser_os_errors_match(tmp_path, lib):
    for path in (tmp_path / "missing.dat", tmp_path):
        want = _outcome(geometry.parse_obstacles_python, path)
        got = _outcome(geometry.load_obstacle_file, path)
        assert got[0] is want[0] and issubclass(got[0], OSError)


def test_canonical_obstacles_parse_natively(tmp_path, lib):
    for case in ("128x256", "1024x1024"):
        mask = geometry.canonical_obstacles(case)
        geometry.write_obstacle_file(tmp_path / "o.dat", mask)
        ny, nx = mask.shape
        _native.reset_calls()
        got, free = geometry.load_obstacle_file(tmp_path / "o.dat", nx, ny)
        assert _native.CALLS["parse_obstacles"] == 1
        np.testing.assert_array_equal(got, mask)
        assert free == geometry.free_cells_of(mask)


def test_concurrent_first_builds_leave_one_library(tmp_path, lib):
    out = tmp_path / "build" / "liblbmio-test.so"
    errors = []

    def build():
        try:
            _native.compile_library(out)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    built = _native.open_library(out)
    av = np.array([1.5, -2.0])
    assert built.lbm_write_av_vels(bytes(tmp_path / "av.dat"), av.ctypes.data, 2, None) == 0
    assert (tmp_path / "av.dat").read_text() == \
        "0:\t1.500000000000E+00\n1:\t-2.000000000000E+00\n"


@pytest.fixture()
def fresh_library():
    _native.library.cache_clear()
    yield
    _native.library.cache_clear()


def test_no_compiler_warns_once_and_writes_the_same(tmp_path, monkeypatch, fresh_library):
    monkeypatch.setattr(_native, "find_compiler", lambda: None)
    monkeypatch.setattr(_native, "library_path", lambda: tmp_path / "liblbmio-none.so")
    av = np.array([0.25, np.nan])
    with pytest.warns(RuntimeWarning, match="no C compiler.*pure-Python"):
        io.write_av_vels(tmp_path / "a.dat", av)
    assert not _native.available()
    io.write_av_vels_python(tmp_path / "b.dat", av)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    mask = geometry.channel_box(8, 6)
    geometry.write_obstacle_file(tmp_path / "o.dat", mask)
    got, free = geometry.load_obstacle_file(tmp_path / "o.dat", 8, 6)
    np.testing.assert_array_equal(got, mask)
    assert free == geometry.free_cells_of(mask)


def test_failed_build_warns_with_the_reason(tmp_path, monkeypatch, fresh_library):
    monkeypatch.setattr(_native, "find_compiler", lambda: ["false"])
    monkeypatch.setattr(_native, "library_path", lambda: tmp_path / "liblbmio-bad.so")
    with pytest.warns(RuntimeWarning, match="failed \\(exit 1\\)"):
        assert not _native.available()
    assert not list(tmp_path.iterdir())
