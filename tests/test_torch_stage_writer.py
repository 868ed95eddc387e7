"""
The stage files' writer (``beat_tpu_torch.npzwrite``) against
``np.savez_compressed``: the same container, member names and order,
``ZIP_DEFLATED``, zip64 extra fields, decompressed bytes and loaded
arrays, on one worker and on a pool of four; the size within 1 % once a
member spans four chunks; an abandoned write leaves no file; several
writers sharing one pool; the counter and the span attribute; a
multi-chunk stage read by the JAX package's ``SampleStage``.
"""

import itertools
import os
import struct
import sys
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import beat_tpu.backend as jbackend
import beat_tpu.utility as jutility
import beat_tpu_torch.backend as pbackend
import beat_tpu_torch.utility as putility
from beat_tpu_torch import npzwrite, profiling

_RNG = np.random.default_rng(18)


def _trace_like(shape, dtype) -> np.ndarray:
    """Uniform rows, each the one before it unless it moved (16 %), as a
    trace's chains keep their row until they move."""
    moved = _RNG.random(shape[0]) < 0.16
    moved[0] = True
    last = np.maximum.accumulate(np.where(moved, np.arange(shape[0]), 0))
    return _RNG.uniform(0.0, 5.0, shape).astype(dtype)[last]


#: the arrays of each case; "several chunks" members span 4 or more chunks
CASES = {
    "zero_d": {"a": np.array(3.5), "b": np.array(7, np.int64), "c": np.array(True)},
    "empty": {"a": np.zeros((0, 3), np.float32), "b": np.zeros((4, 0), np.int64)},
    "under_one_chunk": {"a": _RNG.normal(size=(100, 7)).astype(np.float32),
                        "b": np.arange(-50, 950, dtype=np.int64),
                        "c": _RNG.random(3000) < 0.3},
    "several_chunks": {"q": _trace_like((1200, 1000), np.float32),
                       "cov": _trace_like((700, 900), np.float64),
                       "idx": _RNG.integers(0, 5000, 700_000).astype(np.int64),
                       "moved": _RNG.random(5_000_000) < 0.16},
    "non_contiguous": {"strided": _trace_like((1400, 1000), np.float64)[:, ::2],
                       "fortran": np.asfortranarray(_trace_like((900, 700), np.float64)),
                       "tail": np.arange(10, dtype=np.float32)},
}


@pytest.fixture(params=[1, 4], ids=["one_worker", "four_workers"])
def workers(request, monkeypatch):
    """The writer's shared pool replaced by one of ``request.param``
    workers (None for one)."""
    n = request.param
    executor = ThreadPoolExecutor(n) if n > 1 else None
    monkeypatch.setattr(npzwrite, "_shared", (executor, n))
    yield n
    if executor is not None:
        executor.shutdown()


def _local_extra(path: str, info: zipfile.ZipInfo) -> bytes:
    """The extra field of a member's local file header."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        header = f.read(zipfile.sizeFileHeader)
        name_len, extra_len = struct.unpack("<HH", header[26:30])
        f.seek(name_len, os.SEEK_CUR)
        return f.read(extra_len)


@pytest.mark.parametrize("case", sorted(CASES))
def test_writer_gives_numpys_file(tmp_path, case, workers):
    arrays = CASES[case]
    want, got = str(tmp_path / "numpy.npz"), str(tmp_path / "port.npz")
    np.savez_compressed(want, **arrays)
    pooled = npzwrite.savez_deflated(got, arrays)

    with np.load(got) as z:
        assert z.files == list(arrays)
        for name, array in arrays.items():
            loaded = z[name]
            assert loaded.dtype == array.dtype and loaded.shape == array.shape, name
            assert loaded.tobytes() == np.ascontiguousarray(array).tobytes(), name

    multi = []          # the arrays whose member spans more than one chunk
    with zipfile.ZipFile(got) as zg, zipfile.ZipFile(want) as zw:
        assert zg.testzip() is None
        assert zg.namelist() == zw.namelist() == [k + ".npy" for k in arrays]
        for ig, iw in zip(zg.infolist(), zw.infolist()):
            assert ig.compress_type == iw.compress_type == zipfile.ZIP_DEFLATED
            assert (ig.external_attr, ig.create_system, ig.extract_version, ig.flag_bits) == (
                iw.external_attr, iw.create_system, iw.extract_version, iw.flag_bits)
            # numpy forces a zip64 extra field (header id 1) on every member
            assert _local_extra(got, ig)[:2] == _local_extra(want, iw)[:2] == b"\x01\x00"
            assert zg.read(ig) == zw.read(iw)
            if ig.file_size > npzwrite.CHUNK:
                multi.append(arrays[ig.filename[:-len(".npy")]].nbytes)
            if workers == 1 or ig.file_size <= npzwrite.CHUNK:
                assert ig.compress_size == iw.compress_size       # one stream, numpy's
    assert pooled == (sum(multi) if workers > 1 else 0)
    if any(n >= 4 * npzwrite.CHUNK for n in multi):
        assert abs(os.path.getsize(got) / os.path.getsize(want) - 1.0) < 0.01


@pytest.mark.parametrize("fail_at", ["first", "middle", "last"])
@pytest.mark.parametrize("earlier", [True, False], ids=["over_a_file", "new_path"])
def test_failed_write_leaves_no_file(tmp_path, monkeypatch, fail_at, earlier):
    executor = ThreadPoolExecutor(4)
    monkeypatch.setattr(npzwrite, "_shared", (executor, 4))
    path = str(tmp_path / "stage_1" / "trace.npz")
    before = None
    if earlier:
        pbackend._atomic_save(path, q=np.arange(10.0))
        with open(path, "rb") as f:
            before = f.read()
    arrays = {"q": _trace_like((1800, 1000), np.float32)}       # 7.2 MB: 7 chunks
    n_chunks = -(-(arrays["q"].nbytes + 128) // npzwrite.CHUNK)  # a 128-byte .npy header
    bad = {"first": 1, "middle": n_chunks // 2, "last": n_chunks}[fail_at]
    deflate, calls = npzwrite._deflate, itertools.count(1)

    def failing(data, zdict, final):
        if next(calls) == bad:
            raise OSError("deflate failed")
        return deflate(data, zdict, final)

    monkeypatch.setattr(npzwrite, "_deflate", failing)
    try:
        with pytest.raises(OSError, match="deflate failed"):
            pbackend._atomic_save(path, **arrays)
        assert not [n for n in os.listdir(tmp_path / "stage_1") if n.endswith(".tmp.npz")]
        if earlier:
            with open(path, "rb") as f:
                assert f.read() == before
        else:
            assert not os.path.exists(path)
        # the pool is whole after the failure
        monkeypatch.setattr(npzwrite, "_deflate", deflate)
        assert pbackend._atomic_save(path, **arrays) == arrays["q"].nbytes
        with np.load(path) as z:
            np.testing.assert_array_equal(z["q"], arrays["q"])
    finally:
        executor.shutdown()


def test_writers_sharing_one_pool(tmp_path, monkeypatch):
    """Three threads write at once through one pool of more workers than
    cores, the interpreter switching threads every 10 us: every file is
    numpy's."""
    n = 2 * (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    executor = ThreadPoolExecutor(n)
    monkeypatch.setattr(npzwrite, "_shared", (executor, n))
    monkeypatch.setattr(npzwrite, "CHUNK", 1 << 16)
    arrays = [{"q": _trace_like((60 + 20 * i, 1000), np.float32), "i": np.array(i)}
              for i in range(3)]
    errors = []

    def write(i):
        try:
            for rep in range(2):
                npzwrite.savez_deflated(str(tmp_path / f"{i}_{rep}.npz"), arrays[i])
        except Exception as e:          # noqa: BLE001  (reported by the main thread)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=write, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        executor.shutdown()
    assert not errors
    for i in range(3):
        np.savez_compressed(str(tmp_path / f"numpy_{i}.npz"), **arrays[i])
        with zipfile.ZipFile(tmp_path / f"numpy_{i}.npz") as zw:
            for rep in range(2):
                with zipfile.ZipFile(tmp_path / f"{i}_{rep}.npz") as zg:
                    assert zg.testzip() is None and zg.namelist() == zw.namelist()
                    assert all(zg.read(m) == zw.read(m) for m in zw.namelist())


def _stage(rng):
    q = _trace_like((4, 500, 300), np.float32)              # 2.4 MB: three chunks
    return ({"q": q, "llk": rng.normal(size=(4, 500)).astype(np.float32)},
            {"beta": 0.25, "population": q[-1].astype(np.float64),
             "cov": np.eye(300), "stage": 1})


def test_stage_write_counts_pooled_bytes(tmp_path, workers):
    rng = np.random.default_rng(0)
    trace, state = _stage(rng)
    handler = pbackend.SampleStage(str(tmp_path), ordering=putility.Ordering([("x", (300,))]))
    before = profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        handler.save_stage(1, trace, state)
        snap = profiling.span_snapshot()
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()
    [write] = [s for s in snap["spans"] if s["name"] == "stage.write"]
    assert write["attrs"] == {"stage": 1, "workers": workers}
    big = trace["q"].nbytes + state["population"].nbytes        # more than one chunk each
    assert snap["counters"]["stage.bytes"] == (big + trace["llk"].nbytes
                                                + state["cov"].nbytes)
    assert snap["counters"]["stage.pool_bytes"] == (big if workers > 1 else 0)
    np.testing.assert_array_equal(handler.load_trace(1).q_trace, trace["q"])


def test_jax_package_reads_a_chunked_stage(tmp_path, workers):
    rng = np.random.default_rng(1)
    trace, state = _stage(rng)
    pbackend.SampleStage(str(tmp_path), ordering=putility.Ordering([("x", (300,))])).save_stage(
        1, trace, state)
    reader = jbackend.SampleStage(str(tmp_path), ordering=jutility.Ordering([("x", (300,))]))
    assert reader.check_stage(1)
    loaded = reader.load_trace(1)
    np.testing.assert_array_equal(loaded.q_trace, trace["q"])
    np.testing.assert_array_equal(loaded.llk_trace, trace["llk"])
    got = reader.load_state(1)
    for key in ("population", "cov"):
        np.testing.assert_array_equal(got[key], state[key])
    assert got["beta"] == 0.25 and got["stage"] == 1
